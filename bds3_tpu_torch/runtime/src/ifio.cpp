// Native IF-capture IO for bds3_tpu_torch.
//
// The reference receiver's runtime is MATLAB fopen/fread plus a packed
// 2-bit capture converter (BDS-3_B2a/include/unpack_cplx.m); this library
// provides the TPU framework's native equivalents: high-throughput
// NUT4NT 2-bit unpack, IQ de-interleave, and readahead-hinted block reads,
// exposed through a plain C ABI for ctypes.
//
// Build: make -C bds3_tpu/runtime  (produces libbds3io.so)

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Unpack NUT4NT 2-bit packed complex samples: each byte holds two
// 4-bit complex samples (low nibble first); within a nibble, bit0 = I
// sign, bit1 = Q sign, bit2 = I magnitude (1->3), bit3 = Q magnitude.
// Output layout: I1,Q1,I2,Q2 per input byte (4*n bytes), matching
// unpack_cplx.m:32-47.
void bds3_unpack_nut4nt(const uint8_t* in, int64_t n, int8_t* out) {
    int8_t lut[256][4];
    for (int v = 0; v < 256; ++v) {
        int lo = v & 15, hi = v >> 4;
        lut[v][0] = (int8_t)((1 + 2 * ((lo >> 2) & 1)) * (1 - 2 * (lo & 1)));
        lut[v][1] = (int8_t)((1 + 2 * ((lo >> 3) & 1)) * (1 - 2 * ((lo >> 1) & 1)));
        lut[v][2] = (int8_t)((1 + 2 * ((hi >> 2) & 1)) * (1 - 2 * (hi & 1)));
        lut[v][3] = (int8_t)((1 + 2 * ((hi >> 3) & 1)) * (1 - 2 * ((hi >> 1) & 1)));
    }
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(out + 4 * i, lut[in[i]], 4);
    }
}

// De-interleave I0,Q0,I1,Q1,... into separate I and Q streams.
void bds3_deinterleave_iq(const int8_t* in, int64_t n_pairs,
                          int8_t* i_out, int8_t* q_out) {
    for (int64_t i = 0; i < n_pairs; ++i) {
        i_out[i] = in[2 * i];
        q_out[i] = in[2 * i + 1];
    }
}

// int8 -> float32 widening (fused scale), for feeding device buffers.
void bds3_int8_to_f32(const int8_t* in, int64_t n, float scale, float* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = scale * (float)in[i];
}

// Block reader with kernel readahead hints.  Returns bytes read, <0 on
// error.
int64_t bds3_pread_block(const char* path, int64_t offset, int64_t n,
                         int8_t* out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
#ifdef POSIX_FADV_SEQUENTIAL
    posix_fadvise(fd, offset, n, POSIX_FADV_SEQUENTIAL);
    posix_fadvise(fd, offset + n, n, POSIX_FADV_WILLNEED);  // prefetch next
#endif
    int64_t done = 0;
    while (done < n) {
        ssize_t r = pread(fd, out + done, (size_t)(n - done), offset + done);
        if (r < 0) { close(fd); return -2; }
        if (r == 0) break;
        done += r;
    }
    close(fd);
    return done;
}

int64_t bds3_file_size(const char* path) {
    struct stat st;
    if (stat(path, &st) != 0) return -1;
    return (int64_t)st.st_size;
}

}  // extern "C"
