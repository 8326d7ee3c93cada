// The fused columnar epoch pass: `k_epoch_updates`, the device half of
// lighthouse_tpu_torch/ops/epoch.py.
//
// Replaces no Pallas kernel. It ports the program the reference jits
// outside Pallas, `_core` (lighthouse_tpu/ops/epoch.py:83, jitted at
// :181): per validator, the inactivity-score update, the three flag
// rewards and the two flag penalties, the inactivity-leak penalty, the
// slashing penalty and the effective-balance hysteresis decision of an
// epoch boundary, over the int64 and bool columns of the whole registry.
//
// Arithmetic: int64 in the reference's operation order, so each product is
// the one numpy forms; products wrap as numpy's do (through uint64), not
// as C++'s undefined signed overflow. Every numerator divided here is
// non-negative by construction (effective balances, the updated scores
// and base rewards are, and so is the balance after its clamp at zero),
// and every divisor positive (the entry refuses an increment or a total of
// increments below 1). That is why C++'s truncating `/` and `%` give
// numpy's floor `//` and `%`: nothing that can be negative is divided.
// WEIGHTS, WEIGHT_DENOMINATOR and the inactivity quotient are
// compile-time constants; the 11 scalars are kernel arguments; the bool
// columns are bytes (0 or 1), read and written as such.
//
// Bound on the H100: bytes. A validator reads 42 B (five int64 columns,
// two bool) and writes 25 B (three int64, one bool) for ~100 operations
// and five int64 divisions by runtime values (the increment, the total of
// increments): 70.3 MB at 2^20 validators, 0.0210 ms at 3.35 TB/s. Design:
// one thread a validator, 256 a block, each column read once, coalesced
// (neighbouring threads on neighbouring elements).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#define LH_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

using i64 = long long;
using u64 = unsigned long long;

constexpr int THREADS = 256;

// ops/epoch.py's constants
constexpr i64 WEIGHTS[3] = {14, 26, 14};  // source, target, head
constexpr i64 WEIGHT_DENOMINATOR = 64;
constexpr int TIMELY_TARGET_FLAG_INDEX = 1;
constexpr int TIMELY_HEAD_FLAG_INDEX = 2;
constexpr i64 INACTIVITY_SCORE_BIAS = 4;
constexpr i64 INACTIVITY_SCORE_RECOVERY_RATE = 16;
constexpr i64 INACTIVITY_PENALTY_QUOTIENT = 1LL << 24;
constexpr i64 INACTIVITY_DIVISOR = INACTIVITY_SCORE_BIAS * INACTIVITY_PENALTY_QUOTIENT;
constexpr i64 W0 = WEIGHTS[0], W1 = WEIGHTS[1], W2 = WEIGHTS[2];

// int64 arithmetic that wraps as numpy's does
__device__ __forceinline__ i64 mul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
__device__ __forceinline__ i64 add(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 sub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 min64(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 max64(i64 a, i64 b) { return a > b ? a : b; }

struct Scalars {
  bool do_deltas, leak;
  i64 bri, total_inc, flag_inc[3], inc, cap, down, up;
};

// one flag's reward (to eligible validators that have it, outside a leak)
// and, but for the head flag, its penalty (to eligible ones that lack it)
template <int FLAG, i64 WEIGHT>
__device__ __forceinline__ void flag_delta(i64& delta, i64 base, i64 part, bool unslashed,
                                           bool eligible, const Scalars& s) {
  const bool has_flag = unslashed && (part & (1LL << FLAG)) != 0;
  const i64 rewards =
      mul(mul(base, WEIGHT), s.flag_inc[FLAG]) / mul(s.total_inc, WEIGHT_DENOMINATOR);
  if (eligible && has_flag && !s.leak) delta = add(delta, rewards);
  if constexpr (FLAG != TIMELY_HEAD_FLAG_INDEX) {
    const i64 penalty = mul(base, WEIGHT) / WEIGHT_DENOMINATOR;
    if (eligible && !has_flag) delta = sub(delta, penalty);
  }
}

__global__ void __launch_bounds__(THREADS)
    k_epoch_updates(const i64* __restrict__ eff_, const uint8_t* __restrict__ unslashed_,
                    const uint8_t* __restrict__ eligible_, const i64* __restrict__ part_,
                    const i64* __restrict__ scores_, const i64* __restrict__ balances_,
                    const i64* __restrict__ slash_, i64* __restrict__ scores_out,
                    i64* __restrict__ balances_out, i64* __restrict__ eff_out,
                    uint8_t* __restrict__ mask_out, const Scalars s, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const i64 eff = eff_[i], part = part_[i], scores = scores_[i];
  const i64 balances = balances_[i], slash = slash_[i];
  const bool unslashed = unslashed_[i] != 0, eligible = eligible_[i] != 0;

  const bool participated_tgt = unslashed && (part & (1LL << TIMELY_TARGET_FLAG_INDEX)) != 0;

  // inactivity-score updates
  const i64 delta_score = participated_tgt ? -min64(1, scores) : INACTIVITY_SCORE_BIAS;
  i64 new_scores = eligible ? add(scores, delta_score) : scores;
  const i64 recovered = sub(new_scores, min64(INACTIVITY_SCORE_RECOVERY_RATE, new_scores));
  if (eligible && !s.leak) new_scores = recovered;
  if (!s.do_deltas) new_scores = scores;

  // flag rewards and penalties
  const i64 base = mul(eff / s.inc, s.bri);
  i64 delta = 0;
  flag_delta<0, W0>(delta, base, part, unslashed, eligible, s);
  flag_delta<1, W1>(delta, base, part, unslashed, eligible, s);
  flag_delta<2, W2>(delta, base, part, unslashed, eligible, s);

  // the inactivity-leak penalty reads the updated score
  const i64 inactivity_penalty = mul(eff, new_scores) / INACTIVITY_DIVISOR;
  if (eligible && !participated_tgt) delta = sub(delta, inactivity_penalty);
  if (!s.do_deltas) delta = 0;

  const i64 balances1 = max64(add(balances, delta), 0);
  // slashing penalties (decrease_balance clamps at zero)
  const i64 balances2 = max64(sub(balances1, slash), 0);

  // the effective-balance hysteresis decision (the flat `cap` arm)
  const bool mask = add(balances2, s.down) < eff || add(eff, s.up) < balances2;
  scores_out[i] = new_scores;
  balances_out[i] = balances2;
  eff_out[i] = min64(sub(balances2, balances2 % s.inc), s.cap);
  mask_out[i] = mask;
}

}  // namespace

LH_EXPORT const char* lh_epoch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// the columns in ops/epoch.py's _ARRAY_FIELDS order, then the four outputs,
// then its _SCALAR_FIELDS in order, n validators
LH_EXPORT int lh_epoch_updates(const void* eff, const void* unslashed_prev,
                               const void* eligible, const void* prev_part,
                               const void* scores, const void* balances,
                               const void* slash_penalty, void* scores_out,
                               void* balances_out, void* eff_out, void* mask_out,
                               int do_deltas, int leak, i64 base_reward_per_inc,
                               i64 total_active_increments, i64 flag_inc_0, i64 flag_inc_1,
                               i64 flag_inc_2, i64 increment, i64 cap, i64 hysteresis_down,
                               i64 hysteresis_up, int n, void* stream) {
  if (n <= 0 || n > INT_MAX - THREADS || increment < 1 || total_active_increments < 1)
    return (int)cudaErrorInvalidValue;
  const Scalars s{do_deltas != 0, leak != 0, base_reward_per_inc, total_active_increments,
                  {flag_inc_0, flag_inc_1, flag_inc_2}, increment, cap, hysteresis_down,
                  hysteresis_up};
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  k_epoch_updates<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const i64*)eff, (const uint8_t*)unslashed_prev, (const uint8_t*)eligible,
      (const i64*)prev_part, (const i64*)scores, (const i64*)balances,
      (const i64*)slash_penalty, (i64*)scores_out, (i64*)balances_out, (i64*)eff_out,
      (uint8_t*)mask_out, s, n);
  return (int)cudaGetLastError();
}
