// Layer stamps of the training steps (utils/profiling.py).
//
// Not a port of a TPU kernel: the JAX package's steps are one XLA program
// each, which its profiler splits by op. A captured CUDA graph has no host
// boundary inside it, so the step bodies launch (or, in a capture, record)
// one of these one-thread kernels at each boundary between layers. Each
// reads the device's nanosecond clock (%globaltimer) and writes it into a
// ring of `rows` steps × `slots` boundaries (int64). Mark 0 opens a step: it
// advances the step counter and clears the step's row, so that the row holds
// the stamps of one step and the counter names it. The kernel is a template
// on the boundary's index, so a trace shows each as clica_mark<k>.
//
// Bound: the launch. A stamp is one load and two stores of one thread; in
// a CUDA graph each mark node costs its hop in the chain of nodes, about
// 1.5 µs, so the captured step keeps a second graph without them.

#include <cuda_runtime.h>

constexpr int kMaxSlots = 16;

template <int K>
__global__ void clica_mark(long long* ring, long long* counter, int rows,
                           int slots) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long step = *counter;
  if (K == 0) {
    step += 1;
    *counter = step;
  }
  long long* row = ring + (step % rows) * slots;
  if (K == 0) {
    for (int k = 1; k < slots; ++k) row[k] = 0;
  }
  row[K] = (long long)now;
}

namespace {

template <int K>
void launch(long long* ring, long long* counter, int rows, int slots,
            cudaStream_t st) {
  clica_mark<K><<<1, 1, 0, st>>>(ring, counter, rows, slots);
}

}  // namespace

extern "C" {

// Stamp boundary k of the current step into ring (rows × slots int64) on
// the stream; k = 0 opens a step (advances *counter, clears its row).
int clica_mark_launch(int k, void* ring, void* counter, int rows, int slots,
                      void* stream) {
  if (rows < 1 || slots < 1 || slots > kMaxSlots || k < 0 || k >= slots)
    return (int)cudaErrorInvalidValue;
  long long* r = (long long*)ring;
  long long* c = (long long*)counter;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 0: launch<0>(r, c, rows, slots, st); break;
    case 1: launch<1>(r, c, rows, slots, st); break;
    case 2: launch<2>(r, c, rows, slots, st); break;
    case 3: launch<3>(r, c, rows, slots, st); break;
    case 4: launch<4>(r, c, rows, slots, st); break;
    case 5: launch<5>(r, c, rows, slots, st); break;
    case 6: launch<6>(r, c, rows, slots, st); break;
    case 7: launch<7>(r, c, rows, slots, st); break;
    case 8: launch<8>(r, c, rows, slots, st); break;
    case 9: launch<9>(r, c, rows, slots, st); break;
    case 10: launch<10>(r, c, rows, slots, st); break;
    case 11: launch<11>(r, c, rows, slots, st); break;
    case 12: launch<12>(r, c, rows, slots, st); break;
    case 13: launch<13>(r, c, rows, slots, st); break;
    case 14: launch<14>(r, c, rows, slots, st); break;
    default: launch<15>(r, c, rows, slots, st); break;
  }
  return (int)cudaGetLastError();
}

const char* clica_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
