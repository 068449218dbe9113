// The sim's device iteration for Hopper (sm_90a): two one-block kernels
// around the water-filling launch, f64, bitwise equal to the torch ops of
// transfer/flowsim_torch.py (the CPU's plain version).
//
// Replaces the body of the reference package's transfer/flowsim_jax.py
// `_segment`/`_step` lax.while_loop, which has no Pallas kernel: XLA fuses
// it on the TPU. On the card the same iteration as torch ops was ~181
// kernels of 128 lanes each plus the solve and the ordered segment sum.
// An iteration is now three launches:
//   sim_pre_f64   the loop condition `go`, the iteration's head (budget,
//                 horizon, drain/stop, `run`), the batched refill from the
//                 ready rings and the membership flags the solve reads
//                 (`active`, `changed`);
//   (the water-filling launch, unchanged, in kernels/waterfill)
//   sim_post_f64  the stall test, the step `dt`, the fluid step, the
//                 per-(job, edge) sums in ascending lane order (the work
//                 of segsum_ordered_f64, folded in), hop completions,
//                 deliveries, job completions and the job-done buffer, the
//                 per-child enqueue and `stop`; and `changed`, the flag
//                 the solve answered, added to the sim's count `solves`.
// Both update the state's own tensors in place, so a CUDA graph of a
// block of iterations records three kernel nodes an iteration.
//
// What bounds them: neither bytes (an iteration reads and writes ~12 kB at
// 128 lanes: ~3.5 ns at 3.35 TB/s) nor arithmetic (~15 f64 operations a
// lane). It is a chain of dependent block-wide steps (barriers, scans,
// min/max reductions), each waiting on at least one round trip to the
// state in L2 (~290 cycles a dependent load on the card), and, in
// sim_post_f64, the per-(job, edge) folds: each adds its lanes one after
// the other in ascending order, as the numpy engine's bincount does.
//
// What the design does about it: one block, its threads following the
// lane count (up to 1,024; lanes past that are strided over the threads,
// so a fleet of 24,576 lanes takes the same kernels); scalars in
// registers, each read once by every thread before any thread writes one
// back; each pass's loads unconditional (indices clamped into range), so
// they are in flight together instead of one behind another's branch;
// any/all and counts through __syncthreads_or/_and, exclusive scans by
// warp shuffles and one word a warp in shared memory; per-stage and
// per-job counts as shared-memory integer atomics (integers, any order);
// the lane values one pass leaves for another (prefixes, flags, chunks,
// the fold's terms gathered into list order by all threads at once) in
// shared memory where they fit (sim_post_f64: ~7,700 lanes), else in a
// device scratch the wrapper allocates once. A fold is a plain loop over
// its staged list, which the compiler pipelines: ~10 cycles a term on the
// card, against 8.5 for a chain of adds on a register and ~22 for the
// same fold written as batches of 16 loads before 16 adds (measured with
// clock64). The eligibility pass took ~900 cycles a branch-guarded load
// before its loads were made unconditional.
//
// Bitwise rules: built with --fmad=false, so `rates * dt` and
// `remaining - moved` stay two roundings; each f64 operation is done once,
// in the order of the torch expressions; host constants (horizon -
// T_EPS, T_EPS, EPS) arrive as the same doubles. Min and max reductions
// and integer scans run in any order; the per-(job, edge) sums do not.
// Torch's masked writes to the dump rows (stage ns, job J) are kept where
// they move a value (the job-done buffer's last slot), so the state equals
// the torch ops' state tensor for tensor.
//
// Entry points have a plain C interface (ctypes); each returns the CUDA
// error code of its launch and neither synchronises nor allocates.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// The tensors and sizes of one sim, in the order of
// kernels/simstep/ops.py::FIELDS (a CPU test holds the two lists equal).
struct SimArgs {
  // state (flowsim_torch._St)
  double* now;
  long long* it;
  long long* events;
  uint8_t* draining;
  uint8_t* stop;
  const double* t_sched;
  long long* chunk_arr;
  double* remaining;
  const uint8_t* conn_alive;
  const uint8_t* arrived;
  long long* ready_buf;
  long long* q_head;
  long long* q_tail;
  long long* relay_occ;
  uint8_t* done_bm;
  uint8_t* enq_bm;
  long long* delivered;
  uint8_t* finished;
  double* finish;
  double* jeg;
  double* jeo;
  double* jeb;
  double* rates;
  uint8_t* last_active;
  uint8_t* rates_valid;
  double* td_time;
  long long* td_job;
  long long* td_n;
  long long* solves;
  // constants (flowsim_torch._Cn)
  const long long* conn_job;
  const long long* conn_sid;
  const uint8_t* conn_valid;
  const double* chunk_size;
  const long long* conn_first;
  const long long* stage_hop;
  const long long* stage_deliver;
  const long long* children;
  const long long* slot_job;
  const long long* slot_need;
  const int* je_off;
  const int* je_idx;
  // scratch
  uint8_t* go;
  uint8_t* run;
  uint8_t* active;
  uint8_t* changed;
  double* w;
  int* excl;
  long long* lane_ch;
  uint8_t* lane_flags;
  double* ord;
  uint8_t* ord_on;
  // sizes and knobs
  long long relay_cap;
  long long max_events;
  double horizon;
  double hz_eps;  // horizon - T_EPS, computed by the host
  double t_eps;
  double eps;
  int ncp;
  int ns;
  int nj;
  int nslot;
  int nseg;
  int qcap;
  int maxch;
  int seq_possible;
  int drain;
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90
// lane flag bits
constexpr uint8_t kMark = 1;     // the lane's bit of a scan (elig, val)
constexpr uint8_t kHas = 2;      // the lane holds a chunk (sim_pre_f64)
constexpr uint8_t kLast = 4;     // the lane was active at the last solve
constexpr uint8_t kActAdv = 8;   // active lane of an advancing step
constexpr uint8_t kNewDone = 16; // its chunk completed this hop now

int threads_for(int ncp) {
  const int t = ((ncp + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// The lane values one phase of a kernel leaves for another: in dynamic
// shared memory behind the kernel's counts where they fit (`staged`),
// else in the scratch of SimArgs.
struct Lanes {
  int* excl;          // a scan's exclusive prefix
  uint8_t* flags;     // the k* bits
  long long* ch;      // sim_post_f64: the lane's chunk
  double* w;          // sim_post_f64: Gbit moved (the fold's terms)
  double* ord;        // sim_post_f64: the terms in (job, edge) list order
  uint8_t* ord_on;    // and their kActAdv bits
};

__host__ __device__ inline size_t align8(size_t b) {
  return (b + 7) & ~(size_t)7;
}

// Bytes of dynamic shared memory: `n_ints` counts, then the lanes
// (sim_post_f64's `post` holds the fold's too). Carves `base` where given.
__host__ __device__ inline size_t lane_bytes(int n_ints, int ncp, bool post,
                                             char* base, Lanes* l) {
  size_t off = (size_t)n_ints * 4;
  const size_t n = (size_t)ncp;
  if (base) l->excl = reinterpret_cast<int*>(base + off);
  off = align8(off + n * 4);
  if (post) {
    if (base) {
      l->w = reinterpret_cast<double*>(base + off);
      l->ord = l->w + n;
      l->ch = reinterpret_cast<long long*>(l->ord + n);
    }
    off += 24 * n;
  }
  if (base) l->flags = reinterpret_cast<uint8_t*>(base + off);
  off += n;
  if (post) {
    if (base) l->ord_on = reinterpret_cast<uint8_t*>(base + off);
    off += n;
  }
  return off;
}

__device__ __forceinline__ Lanes lanes(const SimArgs& a, int n_ints,
                                       bool post, bool staged, int* smem) {
  Lanes l{a.excl, a.lane_flags, a.lane_ch, a.w, a.ord, a.ord_on};
  if (staged)
    lane_bytes(n_ints, a.ncp, post, reinterpret_cast<char*>(smem), &l);
  return l;
}

// Exclusive prefix of v over the block's threads in thread order; *total
// gets the block's sum. wsum holds a word a warp. Ends on a barrier, so
// calls may follow each other.
__device__ __forceinline__ int block_excl_scan(int v, int* wsum,
                                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
  for (int k = 0; k < nw; ++k) {
    const int s = wsum[k];
    before += k < warp ? s : 0;
    tot += s;
  }
  __syncthreads();
  *total = tot;
  return before + x - v;
}

// The exclusive prefix over lanes of the lanes' kMark bits into l.excl.
// Lanes are strided over the threads (lane c0 + threadIdx.x for c0 = 0,
// T, 2T, ...), so the prefix runs chunk by chunk with a carry. Ends on a
// barrier: every prefix is visible.
__device__ __forceinline__ void scan_marks(int ncp, const Lanes& l,
                                           int* wsum) {
  const int T = blockDim.x;
  int carry = 0;
  for (int c0 = 0; c0 < ncp; c0 += T) {
    const int i = c0 + threadIdx.x;
    const int v = i < ncp ? (l.flags[i] & kMark) != 0 : 0;
    int tot;
    const int e = block_excl_scan(v, wsum, &tot);
    if (i < ncp) l.excl[i] = carry + e;
    carry += tot;
  }
  __syncthreads();
}

// flowsim_torch._base_go & ~_use_seq, the head of _iteration, the batched
// refill (flowsim_torch._cascade_batch; unless `seq`: the host runs the
// sequential cascade after this launch) and the membership flags of the
// solve. The refill: each idle lane takes the next chunk of its stage's
// ready ring, lanes of a stage in ascending order, as many as it holds.
__global__ void __launch_bounds__(kMaxThreads)
sim_pre_kernel(const __grid_constant__ SimArgs a, int seq, int staged) {
  __shared__ int wsum[32];
  extern __shared__ __align__(8) int cnt[];  // [ns + 1] takes a stage
  const Lanes l = lanes(a, a.ns + 1, false, staged, cnt);
  const int T = blockDim.x, tid = threadIdx.x, ncp = a.ncp, ns = a.ns;
  for (int s = tid; s <= ns; s += T) cnt[s] = 0;
  // every thread reads the scalars before the first barrier; thread 0
  // writes them back only at the end
  const double now = *a.now;
  const long long it = *a.it;
  const bool draining0 = *a.draining != 0, stop0 = *a.stop != 0;
  const double t_sched = *a.t_sched;
  const bool rates_valid = *a.rates_valid != 0;
  bool full = false;  // a relay buffer at capacity: the sequential cascade
  if (!seq && a.seq_possible)
    for (int s = tid; s < ns; s += T) full |= a.relay_occ[s] >= a.relay_cap;
  const bool use_seq = __syncthreads_or(full);
  const bool would = !draining0 && (t_sched <= now + a.t_eps);
  const bool go = !stop0 && it < a.max_events && !would && !use_seq;
  const bool cross = now >= a.hz_eps;
  bool draining = draining0, stop = stop0;
  if (a.drain)
    draining = draining0 || (go && cross);
  else
    stop = go ? cross : stop0;
  const bool run = go && !stop && !draining;

  // ---- each lane's state and eligibility (every load unconditional, so
  // they are in flight together), and the prefix of the eligible lanes
  int carry = 0;
  for (int c0 = 0; c0 < ncp; c0 += T) {
    const int i = c0 + tid;
    bool elig = false;
    if (i < ncp) {
      const long long c = a.chunk_arr[i];
      const bool alive = a.conn_alive[i] != 0, valid = a.conn_valid[i] != 0;
      const bool last = a.last_active[i] != 0;
      const long long s = a.conn_sid[i];
      const bool arrived = a.arrived[a.conn_job[i]] != 0;
      const long long qlen = a.q_tail[s] - a.q_head[s];
      elig = !seq && run && (c < 0) & alive & valid & arrived & (qlen > 0);
      l.flags[i] = (uint8_t)((elig ? kMark : 0) | (c >= 0 ? kHas : 0)
                             | (last ? kLast : 0));
    }
    if (!seq) {
      int tot;
      const int e = block_excl_scan(elig, wsum, &tot);
      if (i < ncp) l.excl[i] = carry + e;
      carry += tot;
    }
  }
  __syncthreads();
  if (!seq && carry > 0) {
    // ---- the takes
    for (int i = tid; i < ncp; i += T) {
      const uint8_t f = l.flags[i];
      if (!(f & kMark)) continue;
      const long long s = a.conn_sid[i];
      const long long rank = l.excl[i] - l.excl[a.conn_first[i]];
      const long long head = a.q_head[s];
      if (rank < a.q_tail[s] - head) {
        a.chunk_arr[i] = a.ready_buf[s * a.qcap + (head + rank) % a.qcap];
        a.remaining[i] = a.chunk_size[i];
        l.flags[i] = f | kHas;
        atomicAdd(&cnt[s], 1);
      }
    }
    __syncthreads();
    for (int s = tid; s <= ns; s += T) {
      const int n = cnt[s];
      if (n) {
        a.q_head[s] += n;
        if (a.stage_hop[s] > 0) a.relay_occ[s] -= n;
      }
    }
  }

  // ---- the solve's membership flags
  bool any_active = false, any_moved = false;
  for (int i = tid; i < ncp; i += T) {
    const uint8_t f = l.flags[i];
    const bool act = (f & kHas) != 0;
    a.active[i] = act;
    any_active |= act;
    any_moved |= act != ((f & kLast) != 0);
  }
  const bool has_active = __syncthreads_or(any_active);
  const bool moved = __syncthreads_or(any_moved);
  if (tid == 0) {
    const bool work = go && !stop && has_active;
    *a.it = it + (go ? 1 : 0);
    *a.draining = draining;
    *a.stop = stop;
    *a.go = go;
    *a.run = run;
    *a.changed = work && (!rates_valid || moved);
  }
}

// flowsim_torch._step after the solve: `rates` is the solve's output.
__global__ void __launch_bounds__(kMaxThreads)
sim_post_kernel(const __grid_constant__ SimArgs a,
                const double* __restrict__ rates, int staged) {
  __shared__ int wsum[32];
  __shared__ double wmax[32], wmin[32];
  extern __shared__ __align__(8) int dyn[];
  int* cnt = dyn;             // [ns + 1] enqueues a stage
  int* bad = dyn + a.ns + 1;  // [nj] slots of a job short of their chunks
  const Lanes l = lanes(a, a.ns + 1 + a.nj, true, staged, dyn);
  const int T = blockDim.x, tid = threadIdx.x, ncp = a.ncp, ns = a.ns;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  for (int s = tid; s <= ns; s += T) cnt[s] = 0;
  for (int j = tid; j < a.nj; j += T) bad[j] = 0;
  const double now = *a.now;
  const long long events = *a.events;
  const bool go = *a.go != 0, stop = *a.stop != 0;
  const bool draining = *a.draining != 0;
  const double t_sched = *a.t_sched;
  const bool rates_valid = *a.rates_valid != 0;
  const long long td_n = *a.td_n;
  const bool changed = *a.changed != 0;

  // ---- amax(rates), amin(where(active, remaining / clamp(rates, EPS),
  // inf)), any(active); each lane's chunk kept for the next pass
  double rmax = -CUDART_INF, rmin = CUDART_INF;
  bool any_active = false;
  for (int i = tid; i < ncp; i += T) {
    const double r = rates[i], rem = a.remaining[i];
    const bool act = a.active[i] != 0;
    l.ch[i] = a.chunk_arr[i];
    rmax = r > rmax ? r : rmax;
    const double ratio = rem / (r < a.eps ? a.eps : r);
    if (act) rmin = ratio < rmin ? ratio : rmin;
    any_active |= act;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double x = __shfl_xor_sync(kFull, rmax, o);
    const double y = __shfl_xor_sync(kFull, rmin, o);
    rmax = x > rmax ? x : rmax;
    rmin = y < rmin ? y : rmin;
  }
  if (lane == 0) {
    wmax[warp] = rmax;
    wmin[warp] = rmin;
  }
  const bool has_active = __syncthreads_or(any_active);
  for (int k = 0; k < nw; ++k) {
    rmax = wmax[k] > rmax ? wmax[k] : rmax;
    rmin = wmin[k] < rmin ? wmin[k] : rmin;
  }

  // ---- the step's scalars, in every thread
  const bool live = go && !stop;
  const bool work = live && has_active, jump = live && !has_active;
  const double t_next = draining ? CUDART_INF : t_sched;
  const bool finite_next = fabs(t_next) < CUDART_INF;  // torch.isfinite
  const bool stalled = work && rmax <= 1e-9 && !finite_next;
  const bool adv = work && !stalled;
  const bool jok = finite_next && t_next < a.hz_eps;
  double dt = rmin < 1e-9 ? 1e-9 : rmin;
  if (finite_next && now + dt > t_next) dt = t_next - now;
  const bool obs_live = !draining;
  const bool cross = adv && (now + dt >= a.hz_eps);
  const bool horizon_hit = !a.drain && cross;
  const bool draining2 = a.drain ? (draining || cross) : draining;
  if (horizon_hit) dt = a.horizon - now;
  const double now2 = adv ? now + dt : (jump && jok ? t_next : now);

  // ---- fluid step and hop completions, lane by lane
  for (int i = tid; i < ncp; i += T) {
    const bool act = a.active[i] != 0;
    const double r = rates[i], rem = a.remaining[i];
    const long long c = l.ch[i], ch = c < 0 ? 0 : c;
    const long long sid = a.conn_sid[i];
    a.rates[i] = r;
    if (work) a.last_active[i] = act;
    const bool aa = act && adv;
    const double moved = r * dt;
    const double rem2 = aa ? rem - moved : rem;
    l.w[i] = aa ? moved : 0.0;
    const bool completed = aa && rem2 <= 1e-9;
    const bool newdone = completed && !a.done_bm[sid * a.qcap + ch];
    if (aa) a.remaining[i] = completed ? 0.0 : rem2;
    if (completed) a.chunk_arr[i] = -1;
    l.ch[i] = ch;
    l.flags[i] = (uint8_t)((aa ? kActAdv : 0) | (newdone ? kNewDone : 0));
    if (newdone) {
      const long long slot = a.stage_deliver[sid];
      if (slot >= 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(&a.delivered[slot]),
                  1ull);
    }
  }
  __syncthreads();

  // ---- hop marks; the fold's terms gathered into list order (every
  // lane is in one (job, edge) list, so the lists hold ncp entries)
  for (int i = tid; i < ncp; i += T)
    if (l.flags[i] & kNewDone)
      a.done_bm[a.conn_sid[i] * a.qcap + l.ch[i]] = 1;
  for (int p = tid; p < ncp; p += T) {
    const int i = a.je_idx[p];
    l.ord[p] = l.w[i];
    l.ord_on[p] = l.flags[i] & kActAdv;
  }
  __syncthreads();

  // ---- per-(job, edge) sums in ascending lane order; slots short of
  // their chunks, counted a job
  for (int s = tid; s < a.nseg; s += T) {
    const int b = a.je_off[s], e = a.je_off[s + 1];
    const double jeg = a.jeg[s], jeo = a.jeo[s], jeb = a.jeb[s];
    double acc = 0.0;
    bool on = false;
    for (int p = b; p < e; ++p) {
      acc = acc + l.ord[p];
      on |= l.ord_on[p] != 0;
    }
    if (adv) a.jeg[s] = jeg + acc;
    if (adv && obs_live) a.jeo[s] = jeo + acc;
    if (adv && obs_live && on) a.jeb[s] = jeb + dt;
  }
  for (int s = tid; s < a.nslot; s += T)
    if (a.delivered[s] < a.slot_need[s]) atomicAdd(&bad[a.slot_job[s]], 1);
  __syncthreads();

  // ---- job completions and the job-done buffer (an exclusive scan over
  // the jobs)
  int carry = 0;
  bool all_fin = true;
  for (int c0 = 0; c0 < a.nj; c0 += T) {
    const int j = c0 + tid;
    bool newly = false;
    if (j < a.nj) {
      const bool job_ok = adv && bad[j] == 0;
      const bool fin = a.finished[j] != 0;
      newly = job_ok && !fin;
      if (job_ok) a.finished[j] = 1;
      if (newly) a.finish[j] = now2;
      all_fin &= fin || job_ok;
    }
    int tot;
    const int e = block_excl_scan(newly, wsum, &tot);
    if (newly) {
      a.td_time[td_n + carry + e] = now2;
      a.td_job[td_n + carry + e] = j;
    }
    carry += tot;
  }
  all_fin = __syncthreads_and(all_fin);
  if (tid == 0 && carry < a.nj) {  // torch's writes of the other jobs
    a.td_time[a.nj] = now2;
    a.td_job[a.nj] = a.nj;
  }

  // ---- the per-child enqueue of completed hops, child by child
  for (int k = 0; k < a.maxch; ++k) {
    for (int i = tid; i < ncp; i += T) {
      const uint8_t f = l.flags[i];
      bool val = false;
      if (f & kNewDone) {
        const long long nsid = a.children[a.conn_sid[i] * a.maxch + k];
        val = nsid >= 0 && !a.enq_bm[nsid * a.qcap + l.ch[i]];
      }
      l.flags[i] = (uint8_t)((f & ~kMark) | (val ? kMark : 0));
    }
    scan_marks(ncp, l, wsum);
    for (int i = tid; i < ncp; i += T) {
      if (!(l.flags[i] & kMark)) continue;
      const long long row = a.children[a.conn_sid[i] * a.maxch + k];
      const long long rank = l.excl[i] - l.excl[a.conn_first[i]];
      const long long ch = l.ch[i];
      a.ready_buf[row * a.qcap + (a.q_tail[row] + rank) % a.qcap] = ch;
      a.enq_bm[row * a.qcap + ch] = 1;
      atomicAdd(&cnt[row], 1);
    }
    __syncthreads();
    for (int s = tid; s <= ns; s += T) {
      const int n = cnt[s];
      a.q_tail[s] += n;
      a.relay_occ[s] += n;
      cnt[s] = 0;
    }
    __syncthreads();
  }

  if (tid == 0) {
    *a.now = now2;
    *a.draining = draining2;
    *a.stop = adv ? (horizon_hit || all_fin)
                  : (jump ? !jok : (stalled || stop));
    *a.events = events + (work ? 1 : 0);
    *a.rates_valid = rates_valid || work;
    *a.td_n = td_n + carry;
    // nothing waits on the count (the host reads it when the sim ends),
    // so no load of it on the kernel's tail
    atomicAdd(reinterpret_cast<unsigned long long*>(a.solves),
              changed ? 1ull : 0ull);
  }
}

// Dynamic shared memory above the default 48 KB needs the attribute, set
// once a kernel at the largest size asked for.
template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes, size_t* configured) {
  if (bytes <= kDefaultSmem || bytes <= *configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

// Launch `kernel` with its lanes staged in shared memory where they fit.
template <typename K, typename... Args>
int launch(K kernel, size_t* configured, int n_ints, bool post,
           const SimArgs* a, void* stream, Args... args) {
  const size_t full = lane_bytes(n_ints, a->ncp, post, nullptr, nullptr);
  const int staged = full <= kMaxSmem;
  const size_t smem = staged ? full : (size_t)n_ints * 4;
  const cudaError_t e = fit_smem(kernel, smem, configured);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, threads_for(a->ncp), smem, (cudaStream_t)stream>>>(
      *a, args..., staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the struct's size, which the wrapper holds against its own
size_t simstep_args_bytes() { return sizeof(SimArgs); }

// `seq` 1: the refill is left to the host's sequential cascade, and `go`
// does not test for a full relay buffer (the host has)
int sim_pre_f64(const SimArgs* a, int seq, void* stream) {
  static size_t configured = 0;
  return launch(sim_pre_kernel, &configured, a->ns + 1, false, a, stream,
                seq);
}

int sim_post_f64(const SimArgs* a, const void* rates, void* stream) {
  static size_t configured = 0;
  return launch(sim_post_kernel, &configured, a->ns + 1 + a->nj, true, a,
                stream, (const double*)rates);
}

}  // extern "C"
