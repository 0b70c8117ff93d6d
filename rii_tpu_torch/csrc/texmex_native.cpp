// TexMex dataset reader of rii_tpu_torch: the strided header-stripping copy
// (the host-side hot loop of dataset ingestion) as a native, OpenMP-parallel
// routine with a plain C interface, loaded with ctypes
// (rii_tpu_torch/native/__init__.py). Built at first use by g++ through
// rii_tpu_torch/ops/_build.py into build/rii_tpu_torch/.
//
// TexMex record layout: int32 dim header + dim payload elements
//   .fvecs: float32 payload, .ivecs: int32 payload, .bvecs: uint8 payload.
//
// The entries read exactly the records they are asked for and fail with -5
// past the end of the file; the Python wrappers clamp the count first.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Probe a TexMex file: returns 0 on success and fills (*dim, *count).
int rii_texmex_probe(const char *path, int elem_bytes, int64_t *dim,
                     int64_t *count) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return errno ? errno : -1;
    int32_t d = 0;
    if (std::fread(&d, sizeof(d), 1, f) != 1) {
        std::fclose(f);
        return -2;
    }
    struct stat st;
    if (fstat(fileno(f), &st) != 0) {
        std::fclose(f);
        return errno ? errno : -3;
    }
    std::fclose(f);
    if (d <= 0) return -4;
    const int64_t rec = 4 + (int64_t)d * elem_bytes;
    *dim = d;
    *count = st.st_size / rec;
    return 0;
}

// Read `count` records starting at record `offset`, stripping the 4-byte dim
// headers, into `out` (count * dim * elem_bytes bytes, caller-allocated).
// mmap + parallel strided copy; returns 0 on success.
int rii_texmex_read(const char *path, int elem_bytes, int64_t dim,
                    int64_t offset, int64_t count, void *out) {
    const int64_t rec = 4 + dim * elem_bytes;
    const int64_t payload = dim * elem_bytes;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return errno ? errno : -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return errno ? errno : -2;
    }
    const int64_t need = (offset + count) * rec;
    if (need > st.st_size) {
        close(fd);
        return -5;  // out of range
    }
    // map only the window we read (page-aligned)
    const int64_t byte_off = offset * rec;
    const int64_t page = sysconf(_SC_PAGESIZE);
    const int64_t map_start = (byte_off / page) * page;
    const int64_t map_len = byte_off + count * rec - map_start;
    void *m = mmap(nullptr, (size_t)map_len, PROT_READ, MAP_PRIVATE, fd,
                   (off_t)map_start);
    close(fd);
    if (m == MAP_FAILED) return errno ? errno : -3;
    madvise(m, (size_t)map_len, MADV_SEQUENTIAL);
    const char *base = (const char *)m + (byte_off - map_start);
    char *dst = (char *)out;

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < count; ++i) {
        std::memcpy(dst + i * payload, base + i * rec + 4, (size_t)payload);
    }

    munmap(m, (size_t)map_len);
    return 0;
}

// uint8 payload -> float32 conversion fused with the strided read (bvecs are
// usually consumed as f32); same contract as rii_texmex_read but `out` is
// count * dim float32.
int rii_texmex_read_b2f(const char *path, int64_t dim, int64_t offset,
                        int64_t count, float *out) {
    const int64_t rec = 4 + dim;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return errno ? errno : -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return errno ? errno : -2;
    }
    if ((offset + count) * rec > st.st_size) {
        close(fd);
        return -5;
    }
    const int64_t byte_off = offset * rec;
    const int64_t page = sysconf(_SC_PAGESIZE);
    const int64_t map_start = (byte_off / page) * page;
    const int64_t map_len = byte_off + count * rec - map_start;
    void *m = mmap(nullptr, (size_t)map_len, PROT_READ, MAP_PRIVATE, fd,
                   (off_t)map_start);
    close(fd);
    if (m == MAP_FAILED) return errno ? errno : -3;
    madvise(m, (size_t)map_len, MADV_SEQUENTIAL);
    const unsigned char *base = (const unsigned char *)m + (byte_off - map_start);

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < count; ++i) {
        const unsigned char *src = base + i * rec + 4;
        float *d = out + i * dim;
        for (int64_t j = 0; j < dim; ++j) d[j] = (float)src[j];
    }

    munmap(m, (size_t)map_len);
    return 0;
}

}  // extern "C"
