"""The kernel build's cache key and the tensor-core split's SASS reader:
host code only, no nvcc and no card."""

import shutil

import pytest

from rii_tpu_torch.benchmarks import tc_split
from rii_tpu_torch.ops import _build


def _copy_csrc(dst):
    for p in _build._CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, dst / p.name)
    return dst


def test_library_path_is_the_same_for_the_same_sources(tmp_path):
    other = _copy_csrc(tmp_path)
    assert _build.library_path("replica_tc", csrc=other) == _build.library_path("replica_tc")


@pytest.mark.parametrize("edit", ["source", "header", "define"])
def test_library_path_changes_with_what_is_built(tmp_path, edit):
    other = _copy_csrc(tmp_path)
    defines = ()
    if edit == "source":
        (other / "replica_tc.cu").write_text((other / "replica_tc.cu").read_text() + "\n")
    elif edit == "header":
        (other / "packed_keys.cuh").write_text((other / "packed_keys.cuh").read_text() + "\n")
    else:
        defines = ("RII_TC_EPILOGUE=0",)
    assert (_build.library_path("replica_tc", defines, csrc=other)
            != _build.library_path("replica_tc"))


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN46_GLOBAL__N__4f72fe39_13_replica_tc_cu_7368d82214tc_scan_kernelILi0ELi0ELi1ELb0EtEEv14CUtensorMap_st
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe20000000800 */
        /*0010*/              @!P0 BRA.U `(.L_x_1) ;                           /* 0x0000000000000000 */
        /*0020*/                   FFMA R3, R4, -2, R5 ;                       /* 0x0000000000000000 */
        /*0030*/                   FFMA R3, R4, -2, R6.reuse ;                 /* 0x0000000000000000 */
\t\tFunction : _ZN46_GLOBAL__N__4f72fe39_13_replica_tc_cu_7368d82214tc_scan_kernelILi1ELi1ELi2ELb0EaEEv14CUtensorMap
        /*0000*/                   I2FP.F32.S32 R1, R2 ;                       /* 0x0000000000000000 */
\t\tFunction : _ZN46_GLOBAL__N__e61738d7_13_replica_tc_cu_7368d82214tc_scan_kernelILi2ELi2ELi1ELb1EEEv14CUtensorMap
        /*0000*/                   SYNCS.ARRIVE.TRANS64 RZ, [R2+URZ], R3 ;     /* 0x0000000000000000 */
\t\tFunction : rii_other_kernel
        /*0000*/                   EXIT ;                                      /* 0x0000000000000000 */
"""


def test_parse_sass_counts_the_bf16_instantiations():
    counts = tc_split.parse_sass(_SASS)
    # the int8 instantiation and other kernels are left out; the parent's
    # mangling (no operand type) is read as bf16
    assert set(counts) == {(0, 0, 1, 0), (2, 2, 1, 1)}
    assert counts[0, 0, 1, 0] == {"LDC": 1, "BRA": 1, "FFMA": 2}
    assert counts[2, 2, 1, 1] == {"SYNCS": 1}
