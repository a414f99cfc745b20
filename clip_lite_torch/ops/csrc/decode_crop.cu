// The native JPEG batch path on the card: nvJPEG decodes a batch of JPEGs
// into one device arena (interleaved RGB), and crop_resize_flip_u8
// (crop_resize.cuh) cuts the tiles out of it.  The counterpart of the JAX
// package's native core (native/clrec_core.cpp:118-242), where libjpeg
// decodes on host threads; the decode here is a library call as it is
// there, the crop-resize-flip the repository's own kernel.
//
// Plain C interface, loaded with ctypes (clip_lite_torch/data/native.py):
//   nvjpeg_info    each JPEG's height and width from its header (0 x 0
//                  where nvJPEG cannot read it or it is not 1 or 3
//                  components: the JAX core cannot turn CMYK into RGB);
//   nvjpeg_decode  the readable ones, with nvjpegDecodeBatched, into the
//                  caller's arena at the caller's offsets, on its stream;
//                  where the batch fails, each image again alone, and the
//                  ones nvJPEG refuses get 0 x 0;
//   crop_resize_flip_u8 (crop_resize.cuh).
// nvJPEG's GPU_HYBRID backend (the Huffman decode too on the card for a
// batch of more than 100 baseline JPEGs, on the host otherwise): the faster
// of the two that an H100 runs (PERF.md); the hardware backend is refused
// there.  One handle per process, one batched and one single-image decode
// state per thread (the loader's producer thread has its own), made at
// first use.
// Errors: a CUDA error code, kNvjpegError + an nvjpegStatus_t, or
// crop::kBadParams.

#include <nvjpeg.h>

#include <mutex>
#include <vector>

#include "crop_resize.cuh"

namespace {

constexpr int kNvjpegError = 10000;
// NVJPEG_STATUS_INCOMPLETE_BITSTREAM: a JPEG cut short inside a header.
constexpr int kIncompleteBitstream = 10;

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;

int get_handle(nvjpegHandle_t* out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (!g_handle) {
    nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_GPU_HYBRID, nullptr,
                                      nullptr, 0, &g_handle);
    if (s != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return kNvjpegError + s;
    }
  }
  *out = g_handle;
  return 0;
}

// This thread's decode states: one for batches (with the batch size it was
// initialised for) and one for single images.
struct ThreadStates {
  nvjpegJpegState_t batched = nullptr;
  nvjpegJpegState_t single = nullptr;
  int batch_size = 0;
  ~ThreadStates() {
    if (batched) nvjpegJpegStateDestroy(batched);
    if (single) nvjpegJpegStateDestroy(single);
  }
};
thread_local ThreadStates t_states;

int state_for(nvjpegHandle_t handle, nvjpegJpegState_t* slot) {
  if (*slot) return 0;
  nvjpegStatus_t s = nvjpegJpegStateCreate(handle, slot);
  return s == NVJPEG_STATUS_SUCCESS ? 0 : kNvjpegError + s;
}

// A status that says something of the image, not of the library or card.
bool refuses_image(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
         (int)s == kIncompleteBitstream;
}

}  // namespace

extern "C" {

// sizes: (n, 2) int32 (height, width), written.
int nvjpeg_info(const unsigned char* const* data, const size_t* lens, int n,
                int* sizes) {
  nvjpegHandle_t handle;
  if (int err = get_handle(&handle)) return err;
  for (int i = 0; i < n; ++i) {
    int components = 0;
    nvjpegChromaSubsampling_t subsampling;
    int widths[NVJPEG_MAX_COMPONENT] = {}, heights[NVJPEG_MAX_COMPONENT] = {};
    nvjpegStatus_t s = nvjpegGetImageInfo(handle, data[i], lens[i], &components,
                                          &subsampling, widths, heights);
    const bool ok = s == NVJPEG_STATUS_SUCCESS &&
                    (components == 1 || components == 3) && widths[0] > 0 &&
                    heights[0] > 0;
    sizes[2 * i] = ok ? heights[0] : 0;
    sizes[2 * i + 1] = ok ? widths[0] : 0;
  }
  return 0;
}

// Decodes every image whose size is not 0 x 0 into arena + offsets[i]
// (pitch 3 x width); sets the size of an image nvJPEG refuses to 0 x 0.
int nvjpeg_decode(const unsigned char* const* data, const size_t* lens, int n,
                  void* arena, const long long* offsets, int* sizes,
                  void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  nvjpegHandle_t handle;
  if (int err = get_handle(&handle)) return err;
  std::vector<int> idx;
  std::vector<const unsigned char*> ptrs;
  std::vector<size_t> lengths;
  std::vector<nvjpegImage_t> dst;
  for (int i = 0; i < n; ++i) {
    if (sizes[2 * i] <= 0) continue;
    nvjpegImage_t image = {};
    image.channel[0] = (unsigned char*)arena + offsets[i];
    image.pitch[0] = (size_t)sizes[2 * i + 1] * 3;
    idx.push_back(i);
    ptrs.push_back(data[i]);
    lengths.push_back(lens[i]);
    dst.push_back(image);
  }
  const int m = (int)idx.size();
  if (m == 0) return 0;
  ThreadStates& ts = t_states;
  if (int err = state_for(handle, &ts.batched)) return err;
  nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
  if (ts.batch_size != m) {
    s = nvjpegDecodeBatchedInitialize(handle, ts.batched, m, 1,
                                      NVJPEG_OUTPUT_RGBI);
    if (s != NVJPEG_STATUS_SUCCESS) return kNvjpegError + s;
    ts.batch_size = m;
  }
  s = nvjpegDecodeBatched(handle, ts.batched, ptrs.data(),
                          lengths.data(), dst.data(), stream);
  if (s == NVJPEG_STATUS_SUCCESS) return (int)cudaGetLastError();
  if (!refuses_image(s)) return kNvjpegError + s;
  // Some image of the batch is refused: decode each alone to find which.
  if (int err = state_for(handle, &ts.single)) return err;
  for (int k = 0; k < m; ++k) {
    s = nvjpegDecode(handle, ts.single, ptrs[k], lengths[k],
                     NVJPEG_OUTPUT_RGBI, &dst[k], stream);
    if (s == NVJPEG_STATUS_SUCCESS) continue;
    if (!refuses_image(s)) return kNvjpegError + s;
    sizes[2 * idx[k]] = sizes[2 * idx[k] + 1] = 0;
  }
  return (int)cudaGetLastError();
}

const char* decode_crop_error_string(int err) {
  if (err == crop::kBadParams)
    return "crop_resize_flip_u8: an image lies outside the arena, has a "
           "negative size or a denom other than 1, 2, 4 or 8";
  if (err < kNvjpegError) return cudaGetErrorString((cudaError_t)err);
  switch (err - kNvjpegError) {
    case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: architecture mismatch";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "nvJPEG: implementation not supported (backend)";
    case kIncompleteBitstream: return "nvJPEG: incomplete bitstream";
    default: return "nvJPEG: unknown status";
  }
}

}  // extern "C"
