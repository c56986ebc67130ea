// Two floors for a kernel that moves a few bytes and waits on them, timed as
// the split kernels are (split_ab.py --rows, exp_pece2d.device_us: profiler
// busy time, each call after a 128 MB write):
//
//   probe_empty_kernel  a launch that does nothing: what the profiler records
//                       for any kernel at all;
//   probe_chain_kernel  one thread's chain of `hops` dependent loads, each
//                       address the value the load before returned, through
//                       lines the 128 MB write evicted from the L2: the slope
//                       over `hops` is one dependent round trip to device
//                       memory.

extern "C" {

__global__ void probe_empty_kernel() {}

__global__ void probe_chain_kernel(const long long* __restrict__ next, int hops,
                                   long long* __restrict__ out) {
  long long i = 0;
  for (int h = 0; h < hops; ++h) i = next[i];
  *out = i;
}

int probe_empty_launch(void* stream) {
  probe_empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int probe_chain_launch(const long long* next, int hops, long long* out, void* stream) {
  probe_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, hops, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
