// K3's wide kernel in block-shape class 1 (65 to 128 taps; topc_wide.cuh).

#include "topc_wide.cuh"

int fwav::topc_wide_n128(const ScanArgs& a, int B, int N, int C, int* out_idx,
                        cudaStream_t stream) {
  return launch_wide_c<1>(a, B, N, C, out_idx, stream);
}

FWAV_WIDE_MARKS_READER(topc_wide_n128)
