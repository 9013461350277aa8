// K3's wide kernel in block-shape class 0 (up to 64 taps; topc_wide.cuh).

#include "topc_wide.cuh"

int fwav::topc_wide_n64(const ScanArgs& a, int B, int N, int C, int* out_idx,
                        cudaStream_t stream) {
  return launch_wide_c<0>(a, B, N, C, out_idx, stream);
}

FWAV_WIDE_MARKS_READER(topc_wide_n64)
