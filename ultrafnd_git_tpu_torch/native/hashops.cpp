// Host C++: FNV-1a hashing and batched hash embeddings (plain C ABI, ctypes).
//
// The port's copy of ultrafnd_git_tpu/native/hashops.cpp, reduced to the
// two entry points the port binds. One pass over all texts, packed into
// one UTF-8 buffer + offsets, tokenized, hashed, scattered and normalised
// into the caller's (N, dim) float32 output.
//
// Semantics (the numpy path of ops/hashing.py agrees within one ulp: it
// divides by the float32 norm where this multiplies by a float64 reciprocal):
//   * tokens split on the codepoints Python's str.split() splits on
//     (Unicode whitespace), not just ASCII space;
//   * 64-bit FNV-1a over the token's UTF-8 bytes, bucket = h % dim;
//   * +1 count per token (the first max_tokens tokens when >= 0);
//   * row L2 normalisation with +1e-9, zero rows left zero.
//
// Built with g++ by ultrafnd_git_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>

extern "C" {

static const uint64_t FNV_PRIME = 0x100000001B3ULL;

// `basis` is the FNV starting state: the FNV offset for the unsalted hash,
// or fnv1a(salt) for a salted draw (continuing from fnv1a(salt) equals
// hashing salt||token in one pass).
uint64_t ufnd_fnv1a64_basis(const uint8_t* data, int64_t len, uint64_t basis) {
    uint64_t h = basis;
    for (int64_t i = 0; i < len; ++i) {
        h ^= (uint64_t)data[i];
        h *= FNV_PRIME;
    }
    return h;
}

// Decode one UTF-8 codepoint at buf[i]; advances *i. An invalid lead byte
// is taken as one opaque non-space codepoint.
static inline uint32_t decode_utf8(const uint8_t* buf, int64_t end, int64_t* i) {
    uint8_t b0 = buf[*i];
    if (b0 < 0x80) { *i += 1; return b0; }
    if ((b0 >> 5) == 0x6 && *i + 1 < end) {
        uint32_t cp = ((b0 & 0x1F) << 6) | (buf[*i + 1] & 0x3F);
        *i += 2; return cp;
    }
    if ((b0 >> 4) == 0xE && *i + 2 < end) {
        uint32_t cp = ((b0 & 0x0F) << 12) | ((buf[*i + 1] & 0x3F) << 6)
                      | (buf[*i + 2] & 0x3F);
        *i += 3; return cp;
    }
    if ((b0 >> 3) == 0x1E && *i + 3 < end) {
        uint32_t cp = ((b0 & 0x07) << 18) | ((buf[*i + 1] & 0x3F) << 12)
                      | ((buf[*i + 2] & 0x3F) << 6) | (buf[*i + 3] & 0x3F);
        *i += 4; return cp;
    }
    *i += 1;
    return b0;
}

// Python str.split() whitespace set (str.isspace() codepoints).
static inline bool is_py_space(uint32_t cp) {
    switch (cp) {
        case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D: case 0x20:
        case 0x1C: case 0x1D: case 0x1E: case 0x1F:
        case 0x85: case 0xA0:
        case 0x1680:
        case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
            return true;
        default:
            return (cp >= 0x2000 && cp <= 0x200A);
    }
}

// texts packed as buf[offsets[i] .. offsets[i+1]); out is (n, dim), zeroed
// by the caller. max_tokens < 0 means unlimited.
void ufnd_hash_embed_batch_basis(const uint8_t* buf, const int64_t* offsets,
                                 int64_t n, int64_t dim, int64_t max_tokens,
                                 uint64_t basis, float* out) {
    for (int64_t r = 0; r < n; ++r) {
        const int64_t end = offsets[r + 1];
        float* row = out + r * dim;
        int64_t i = offsets[r];
        int64_t tok_count = 0;
        while (i < end) {
            int64_t j = i;  // skip whitespace
            while (j < end) {
                int64_t k = j;
                if (!is_py_space(decode_utf8(buf, end, &k))) break;
                j = k;
            }
            if (j >= end) break;
            int64_t tok_end = j;  // scan the token
            while (tok_end < end) {
                int64_t k = tok_end;
                if (is_py_space(decode_utf8(buf, end, &k))) break;
                tok_end = k;
            }
            if (max_tokens >= 0 && tok_count >= max_tokens) break;
            uint64_t h = ufnd_fnv1a64_basis(buf + j, tok_end - j, basis);
            row[(int64_t)(h % (uint64_t)dim)] += 1.0f;
            ++tok_count;
            i = tok_end;
        }
        double sq = 0.0;
        for (int64_t c = 0; c < dim; ++c) sq += (double)row[c] * row[c];
        if (sq > 0.0) {
            const float inv = (float)(1.0 / (std::sqrt(sq) + 1e-9));
            for (int64_t c = 0; c < dim; ++c) row[c] *= inv;
        }
    }
}

}  // extern "C"
