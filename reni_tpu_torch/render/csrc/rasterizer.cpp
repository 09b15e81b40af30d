// Triangle rasterizer producing PyTorch3D-style fragments (the port's copy
// of native/rasterizer.cpp; the code below is that file's, line for line).
//
// Replaces the reference's PyTorch3D CUDA MeshRasterizer (reference:
// src/utils/pytorch3d_envmap_shader.py:197-208), scoped to its settings:
// faces_per_pixel=1, blur_radius=0, perspective_correct=False, square
// viewport. Rasterization is outside the gradient path (fragments are
// constants w.r.t. the latents), and the camera and mesh are static per
// task, so this runs once on the host at set-up; the differentiable
// Blinn-Phong shading (reni_tpu_torch/render/shading.py) consumes the
// fragments on the device.
//
// Conventions (must match reni_tpu_torch/render/mesh.py):
//   inputs are NDC verts (x_ndc, y_ndc, z_view); +X left, +Y up;
//   pixel (i, j) center has x_ndc = 1 - (2j+1)/W, y_ndc = 1 - (2i+1)/H;
//   screen-space barycentrics; z-buffer on view-space z; no backface cull.
//
// Build (reni_tpu_torch/render/rasterizer.py does it at first use):
//   g++ -O3 -shared -fPIC rasterizer.cpp -o librasterizer.so
// The flags are the JAX package's own: another -O or -march may reorder the
// float edge functions and flip a pixel's face.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

inline float edge(float ax, float ay, float bx, float by, float px, float py) {
  return (px - ax) * (by - ay) - (py - ay) * (bx - ax);
}

}  // namespace

extern "C" {

// verts_ndc: V*3 floats; faces: F*3 ints; outputs sized H*W (pix_to_face,
// zbuf) and H*W*3 (barycentrics). pix_to_face = -1 where no face covers.
void rasterize_mesh(const float* verts_ndc, const int32_t* faces,
                    int32_t n_verts, int32_t n_faces, int32_t height,
                    int32_t width, float znear, int32_t* pix_to_face,
                    float* bary, float* zbuf) {
  (void)n_verts;
  const int64_t n_pix = (int64_t)height * width;
  for (int64_t p = 0; p < n_pix; ++p) {
    pix_to_face[p] = -1;
    zbuf[p] = INFINITY;
    bary[3 * p] = bary[3 * p + 1] = bary[3 * p + 2] = 0.f;
  }

  for (int32_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    const float x0 = verts_ndc[3 * i0], y0 = verts_ndc[3 * i0 + 1],
                z0 = verts_ndc[3 * i0 + 2];
    const float x1 = verts_ndc[3 * i1], y1 = verts_ndc[3 * i1 + 1],
                z1 = verts_ndc[3 * i1 + 2];
    const float x2 = verts_ndc[3 * i2], y2 = verts_ndc[3 * i2 + 1],
                z2 = verts_ndc[3 * i2 + 2];
    if (z0 <= znear && z1 <= znear && z2 <= znear) continue;

    const float area = edge(x0, y0, x1, y1, x2, y2);
    if (std::fabs(area) < 1e-12f) continue;

    // NDC -> pixel-index bounds. x_ndc = 1 - (2j+1)/W  =>  j = (1-x)*W/2 - .5
    const float xmin = std::min(x0, std::min(x1, x2));
    const float xmax = std::max(x0, std::max(x1, x2));
    const float ymin = std::min(y0, std::min(y1, y2));
    const float ymax = std::max(y0, std::max(y1, y2));
    int32_t j0 = (int32_t)std::floor((1.f - xmax) * width / 2.f - 0.5f);
    int32_t j1 = (int32_t)std::ceil((1.f - xmin) * width / 2.f - 0.5f);
    int32_t r0 = (int32_t)std::floor((1.f - ymax) * height / 2.f - 0.5f);
    int32_t r1 = (int32_t)std::ceil((1.f - ymin) * height / 2.f - 0.5f);
    j0 = std::max(j0, 0); j1 = std::min(j1, width - 1);
    r0 = std::max(r0, 0); r1 = std::min(r1, height - 1);

    const float inv_area = 1.f / area;
    for (int32_t r = r0; r <= r1; ++r) {
      const float py = 1.f - (2.f * r + 1.f) / height;
      for (int32_t j = j0; j <= j1; ++j) {
        const float px = 1.f - (2.f * j + 1.f) / width;
        float w0 = edge(x1, y1, x2, y2, px, py) * inv_area;
        float w1 = edge(x2, y2, x0, y0, px, py) * inv_area;
        float w2 = edge(x0, y0, x1, y1, px, py) * inv_area;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        const float z = w0 * z0 + w1 * z1 + w2 * z2;
        if (z <= znear) continue;
        const int64_t p = (int64_t)r * width + j;
        if (z < zbuf[p]) {
          zbuf[p] = z;
          pix_to_face[p] = f;
          bary[3 * p] = w0;
          bary[3 * p + 1] = w1;
          bary[3 * p + 2] = w2;
        }
      }
    }
  }
}

}  // extern "C"
