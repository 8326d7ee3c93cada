// SHA-256 merkle-node compression: `k_sha256_pairs`, the device half of
// lighthouse_tpu_torch/ops/lane/sha256.py.
//
// Replaces no Pallas kernel. It ports the program the reference jits
// outside Pallas, `_digest_pairs` (lighthouse_tpu/ops/lane/sha256.py:150;
// its rounds :120, the padding block's schedule :75 / :94, jitted at
// :188): the digest of N merkle nodes, each SHA-256 over the 64 bytes of
// two 32-byte children, i.e. two compressions, the data block with its 48
// schedule steps, then the constant padding block, whose K + W are the
// input-independent `_KW_PAD`.
//
// Layout: node i's children are the eight words at left + i * stride and at
// right + i * stride, its digest the eight words at out + 8 * i, each word
// the big-endian value of its 4 bytes (the host made them, `>u4`), so no
// byte is swapped here. A caller hashing two (N, 8) arrays passes stride 8;
// a tree level passes its layer in place, rows 2j and 2j + 1 (left =
// layer, right = layer + 8, stride 16), with no gather.
//
// Bound on the H100: operations. A node is two compressions of about 2,950
// int32 operations each in the reference's count (sha256.py:31-33), on 96
// bytes moved: ~61 operations a byte, six times the card's 33.5e12 /
// 3.35e12. Design: one thread a node, 128 a block, its 16 message words
// read as four 16-byte loads and its digest written as two. Both blocks'
// 64 rounds are unrolled at compile time (templates over the round), so
// K and _KW_PAD are immediates in the instructions, not constant-bank or
// memory reads, and the state's eight words rotate by name, not by moves.
// The schedule is a 16-word window in registers. Rotations are funnel
// shifts; ch and maj are three-input logic (LOP3).
#include <climits>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#define LH_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int THREADS = 128;

// FIPS 180-4 round constants; lighthouse_tpu_torch/ops/lane/sha256.py `K`
constexpr uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

// K[t] + W[t] of the constant padding block (0x80, zeros, bit length 512);
// sha256.py `_KW_PAD`
constexpr uint32_t kKWPad[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u};

// the initial state; sha256.py `IV`
constexpr uint32_t kIV[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au, 0x510e527fu, 0x9b05688cu,
    0x1f83d9abu, 0x5be0cd19u};

// One word a constant of its own, read at a template's round or word index
// only, so that each is an immediate of the instruction that adds it (a
// constexpr scalar is usable in device code; an array is not).
template <int T>
constexpr uint32_t K_AT = kK[T];
template <int T>
constexpr uint32_t KW_PAD_AT = kKWPad[T];
template <int I>
constexpr uint32_t IV_AT = kIV[I];

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}
__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}
__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) {
  return (e & f) ^ (~e & g);
}
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) ^ (a & c) ^ (b & c);
}

// Round T on the state v, whose words rotate by one slot a round: a sits
// at v[(-T) & 7], b after it, ..., h last. The round writes the new e over
// d and the new a over h, which is where the next round reads them.
template <int T>
__device__ __forceinline__ void sha_round(uint32_t (&v)[8], uint32_t kw) {
  constexpr int o = (64 - T) & 7;
  const uint32_t a = v[o], b = v[(o + 1) & 7], c = v[(o + 2) & 7];
  const uint32_t e = v[(o + 4) & 7], f = v[(o + 5) & 7], g = v[(o + 6) & 7];
  const uint32_t t1 = v[(o + 7) & 7] + big_sigma1(e) + ch(e, f, g) + kw;
  const uint32_t t2 = big_sigma0(a) + maj(a, b, c);
  v[(o + 3) & 7] += t1;
  v[(o + 7) & 7] = t1 + t2;
}

// The data block's round T; from T = 16 on, the schedule's next word
// first, over the window slot that held W[T - 16].
template <int T>
__device__ __forceinline__ void data_round(uint32_t (&v)[8], uint32_t (&w)[16]) {
  if constexpr (T >= 16) {
    w[T & 15] += small_sigma0(w[(T - 15) & 15]) + w[(T - 7) & 15] +
                 small_sigma1(w[(T - 2) & 15]);
  }
  sha_round<T>(v, K_AT<T> + w[T & 15]);
}

template <int T>
__device__ __forceinline__ void pad_round(uint32_t (&v)[8]) {
  sha_round<T>(v, KW_PAD_AT<T>);
}

template <int... T>
__device__ __forceinline__ void data_block(uint32_t (&v)[8], uint32_t (&w)[16],
                                           std::integer_sequence<int, T...>) {
  (data_round<T>(v, w), ...);
}

template <int... T>
__device__ __forceinline__ void pad_block(uint32_t (&v)[8], std::integer_sequence<int, T...>) {
  (pad_round<T>(v), ...);
}

template <int... I>
__device__ __forceinline__ void init_state(uint32_t (&v)[8], std::integer_sequence<int, I...>) {
  ((v[I] = IV_AT<I>), ...);
}

template <int... I>
__device__ __forceinline__ void add_iv(uint32_t (&v)[8], std::integer_sequence<int, I...>) {
  ((v[I] += IV_AT<I>), ...);
}

__global__ void __launch_bounds__(THREADS)
    k_sha256_pairs(const uint32_t* __restrict__ left, const uint32_t* __restrict__ right,
                   uint32_t* __restrict__ out, int stride, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint4* l = reinterpret_cast<const uint4*>(left + (long)i * stride);
  const uint4* r = reinterpret_cast<const uint4*>(right + (long)i * stride);
  const uint4 l0 = l[0], l1 = l[1], r0 = r[0], r1 = r[1];
  uint32_t w[16] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w,
                    r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  constexpr auto rounds = std::make_integer_sequence<int, 64>{};
  constexpr auto words = std::make_integer_sequence<int, 8>{};
  uint32_t v[8];
  init_state(v, words);
  data_block(v, w, rounds);  // 64 rounds: v is back in its slots
  add_iv(v, words);          // the state after block 1
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = v[j];
  pad_block(v, rounds);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] += v[j];
  uint4* o = reinterpret_cast<uint4*>(out + 8 * (long)i);
  o[0] = make_uint4(h[0], h[1], h[2], h[3]);
  o[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace

LH_EXPORT const char* lh_sha256_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// n nodes; stride (in words) of the child rows, a multiple of 4 so that
// every row starts on 16 bytes, as must left, right and out
LH_EXPORT int lh_sha256_pairs(const void* left, const void* right, void* out, int stride,
                              int n, void* stream) {
  if (n <= 0 || n > INT_MAX - THREADS || stride < 8 || stride % 4 ||
      ((uintptr_t)left | (uintptr_t)right | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  k_sha256_pairs<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)left, (const uint32_t*)right, (uint32_t*)out, stride, n);
  return (int)cudaGetLastError();
}
