// JPEG decode on the card through nvJPEG, plain C interface for ctypes.
//
// Replaces no TPU kernel. It is the counterpart of the host library the
// JAX package decodes with (cv2.imread / cv2.imdecode(IMREAD_COLOR) in
// feature/image/imageset.py and preprocessing.py): the card's machine has
// neither cv2 nor PIL, and its CUDA toolkit ships nvJPEG. The wrapper is
// feature/image/codecs.py (decode_image, nvjpeg_decode).
//
// One image a call: nvjpegDecode with NVJPEG_OUTPUT_RGBI writes interleaved
// RGB, (height, width, 3) uint8 with a pitch of 3 * width, into a buffer the
// wrapper allocated with torch.empty on the card, on the caller's stream.
// nvJPEG's default backend decodes the Huffman stream on the host and runs
// the IDCT, upsampling and colour conversion on the card, so the call
// returns once its device work is queued. Greyscale files come out with
// R = G = B = Y, as cv2's IMREAD_COLOR gives them. The wrapper parses the
// markers first and raises on what nvJPEG is not asked to take here
// (CMYK, YCCK, arithmetic coding, lossless and hierarchical frames).
//
// The library handle is shared; a decode state is kept per host thread
// (ImageSet.read decodes on a thread pool), since one state must not serve
// two decodes at once. Returns 0, or an nvjpegStatus_t, or, after the
// decode, a cudaError_t offset by ZOO_CUDA_ERROR_BASE (the wrapper tells
// them apart and names each).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>

#define ZOO_CUDA_ERROR_BASE 1000
#define ZOO_SIZE_MISMATCH 999

static nvjpegHandle_t g_handle = nullptr;
static std::mutex g_handle_lock;

static nvjpegStatus_t handle(nvjpegHandle_t* out) {
  std::lock_guard<std::mutex> guard(g_handle_lock);
  if (g_handle == nullptr) {
    nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return st;
    }
  }
  *out = g_handle;
  return NVJPEG_STATUS_SUCCESS;
}

static thread_local nvjpegJpegState_t t_state = nullptr;

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (width, height, components) of the first frame as nvJPEG reads them.
static int jpeg_info(const unsigned char* data, long long length,
                     int* info) {
  nvjpegHandle_t h;
  nvjpegStatus_t st = handle(&h);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  st = nvjpegGetImageInfo(h, data, static_cast<size_t>(length), &n_comp,
                          &sub, widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  info[0] = widths[0];
  info[1] = heights[0];
  info[2] = n_comp;
  return 0;
}

extern "C" int zoo_jpeg_decode(const unsigned char* data, long long length,
                               unsigned char* out, int width, int height,
                               void* stream) {
  nvjpegHandle_t h;
  nvjpegStatus_t st = handle(&h);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  int info[3];
  int rc = jpeg_info(data, length, info);
  if (rc != 0) return rc;
  if (info[0] != width || info[1] != height) return ZOO_SIZE_MISMATCH;
  if (t_state == nullptr) {
    st = nvjpegJpegStateCreate(h, &t_state);
    if (st != NVJPEG_STATUS_SUCCESS) {
      t_state = nullptr;
      return st;
    }
  }
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(width) * 3;
  st = nvjpegDecode(h, t_state, data, static_cast<size_t>(length),
                    NVJPEG_OUTPUT_RGBI, &image,
                    static_cast<cudaStream_t>(stream));
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : ZOO_CUDA_ERROR_BASE + err;
}
