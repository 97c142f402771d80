// Native image preprocessing: resize-shortest-edge + pad + pack.
//
// The port's copy of native/preproc.cc (the JAX package's), standing in for
// the reference's dataloader worker processes (detectron2
// build_detection_test_loader workers + DatasetMapper3D resize): the
// host-side loop that feeds the device. One call preprocesses a whole batch
// with an OpenMP thread pool: no Python in the inner loop, no GIL.
//
// Bilinear resampling uses the half-pixel-center convention (matches
// cv2.resize INTER_LINEAR), clamped at borders.
//
// Built at first use by ovmono3d_tpu_torch/data/native.py
// (g++ -O3 -fopenmp -fPIC -c, linked -shared against PyTorch's
// libgomp.so.1, into build/native/).
// ABI: plain C, consumed via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Resize one uint8 HWC image to (nh, nw) with bilinear filtering, write
// float32 output (no normalization).
static void resize_bilinear_u8(
    const uint8_t* src, int h, int w, int channels,
    float* dst, int nh, int nw) {
  const float sy = static_cast<float>(h) / nh;
  const float sx = static_cast<float>(w) / nw;
  for (int y = 0; y < nh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float ly = fy - y0;
    int y1 = std::min(y0 + 1, h - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < nw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float lx = fx - x0;
      int x1 = std::min(x0 + 1, w - 1);
      x0 = std::max(x0, 0);
      const uint8_t* p00 = src + (y0 * w + x0) * channels;
      const uint8_t* p01 = src + (y0 * w + x1) * channels;
      const uint8_t* p10 = src + (y1 * w + x0) * channels;
      const uint8_t* p11 = src + (y1 * w + x1) * channels;
      float w00 = (1 - ly) * (1 - lx), w01 = (1 - ly) * lx;
      float w10 = ly * (1 - lx), w11 = ly * lx;
      float* out = dst + (y * nw + x) * channels;
      for (int c = 0; c < channels; ++c) {
        out[c] = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
      }
    }
  }
}

// Shortest-edge resize geometry (detectron2 ResizeShortestEdge):
// scale so min side == short_side, capped so max side <= max_size.
static void shortest_edge(int h, int w, int short_side, int max_size,
                          int* nh, int* nw, float* scale) {
  float s = static_cast<float>(short_side) / std::min(h, w);
  if (std::max(h, w) * s > max_size) {
    s = static_cast<float>(max_size) / std::max(h, w);
  }
  *nh = static_cast<int>(std::lround(h * s));
  *nw = static_cast<int>(std::lround(w * s));
  *scale = s;
}

// Preprocess a batch:
//   images   : array of B pointers to uint8 HWC RGB buffers
//   heights/widths : per-image dims
//   batch    : B
//   out_size : padded square side S
//   short_side / max_size : resize rule
//   out_images : [B, S, S, 3] float32 (zero-padded), raw 0..255 values
//   out_hw     : [B, 2] int32 valid region
//   out_ratios : [B] float32 original/network scale (1/s)
// Returns 0 on success.
int preprocess_batch(
    const uint8_t** images, const int* heights, const int* widths,
    int batch, int out_size, int short_side, int max_size,
    float* out_images, int* out_hw, float* out_ratios) {
  const long plane = static_cast<long>(out_size) * out_size * 3;
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    float* canvas = out_images + b * plane;
    std::memset(canvas, 0, plane * sizeof(float));
    int nh, nw;
    float s;
    shortest_edge(heights[b], widths[b], short_side,
                  std::min(max_size, out_size), &nh, &nw, &s);
    nh = std::min(nh, out_size);
    nw = std::min(nw, out_size);
    // resize directly into a temp row-major buffer then copy rows into the
    // padded canvas
    float* tmp = new float[static_cast<long>(nh) * nw * 3];
    resize_bilinear_u8(images[b], heights[b], widths[b], 3, tmp, nh, nw);
    for (int y = 0; y < nh; ++y) {
      std::memcpy(canvas + (static_cast<long>(y) * out_size) * 3,
                  tmp + (static_cast<long>(y) * nw) * 3,
                  nw * 3 * sizeof(float));
    }
    delete[] tmp;
    out_hw[b * 2 + 0] = nh;
    out_hw[b * 2 + 1] = nw;
    out_ratios[b] = 1.0f / s;
  }
  return 0;
}

}  // extern "C"
