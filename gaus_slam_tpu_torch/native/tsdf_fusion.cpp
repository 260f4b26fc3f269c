// Scalable TSDF volume fusion + marching-tetrahedra mesh extraction.
//
// Native replacement for the Open3D ScalableTSDFVolume pipeline the
// reference uses for mesh evaluation and visualization
// (utils/eval.py:337-399, open3d_ui/vis_mesh.py). Voxels live in
// lazily-allocated 16^3 blocks in a hash map, so memory scales with the
// observed surface, not the bounding box. Mesh extraction uses marching
// tetrahedra (6 tets per cube): slightly denser triangulation than
// marching cubes but table-free and watertight across block borders.
//
// C ABI (ctypes-friendly); all poses are row-major 4x4 c2w matrices.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int BLOCK = 16;

struct Voxel {
  float tsdf = 1.0f;
  float weight = 0.0f;
  float r = 0, g = 0, b = 0;
};

struct BlockKey {
  int32_t x, y, z;
  bool operator==(const BlockKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct BlockHash {
  size_t operator()(const BlockKey& k) const {
    return ((size_t)(uint32_t)k.x * 73856093u) ^
           ((size_t)(uint32_t)k.y * 19349669u) ^
           ((size_t)(uint32_t)k.z * 83492791u);
  }
};

struct Block {
  Voxel v[BLOCK * BLOCK * BLOCK];
};

struct Volume {
  float voxel_size;
  float sdf_trunc;
  std::unordered_map<BlockKey, Block*, BlockHash> blocks;
  ~Volume() {
    for (auto& kv : blocks) delete kv.second;
  }

  Voxel* find(int32_t vx, int32_t vy, int32_t vz) {
    BlockKey k{(int32_t)std::floor((float)vx / BLOCK),
               (int32_t)std::floor((float)vy / BLOCK),
               (int32_t)std::floor((float)vz / BLOCK)};
    auto it = blocks.find(k);
    if (it == blocks.end()) return nullptr;
    int lx = vx - k.x * BLOCK, ly = vy - k.y * BLOCK, lz = vz - k.z * BLOCK;
    return &it->second->v[(lz * BLOCK + ly) * BLOCK + lx];
  }

  Voxel* touch(int32_t vx, int32_t vy, int32_t vz) {
    BlockKey k{(int32_t)std::floor((float)vx / BLOCK),
               (int32_t)std::floor((float)vy / BLOCK),
               (int32_t)std::floor((float)vz / BLOCK)};
    auto it = blocks.find(k);
    if (it == blocks.end()) it = blocks.emplace(k, new Block()).first;
    int lx = vx - k.x * BLOCK, ly = vy - k.y * BLOCK, lz = vz - k.z * BLOCK;
    return &it->second->v[(lz * BLOCK + ly) * BLOCK + lx];
  }
};

}  // namespace

extern "C" {

void* tsdf_create(float voxel_size, float sdf_trunc) {
  auto* v = new Volume();
  v->voxel_size = voxel_size;
  v->sdf_trunc = sdf_trunc;
  return v;
}

void tsdf_destroy(void* h) { delete (Volume*)h; }

int64_t tsdf_num_blocks(void* h) { return (int64_t)((Volume*)h)->blocks.size(); }

// Integrate one RGB-D frame. depth: [h*w] meters (<=0 invalid);
// color: [h*w*3] 0..1; intr: fx fy cx cy; c2w row-major 4x4.
void tsdf_integrate(void* h, const float* depth, const float* color, int height,
                    int width, const float* intr, const float* c2w,
                    float depth_trunc) {
  Volume& vol = *(Volume*)h;
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const float vs = vol.voxel_size, tr = vol.sdf_trunc;
  // w2c = inverse of rigid c2w
  float R[9], t[3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) R[i * 3 + j] = c2w[j * 4 + i];  // transpose
  for (int i = 0; i < 3; i++) {
    t[i] = 0;
    for (int j = 0; j < 3; j++) t[i] -= R[i * 3 + j] * c2w[j * 4 + 3];
  }

  // Phase 1 — allocate + collect the blocks touched by this frame's
  // depth band (one march per pixel). Phase 2 then updates EVERY voxel
  // of each touched block by projecting its center into the image
  // (Open3D ScalableTSDFVolume semantics). The old per-pixel voxel
  // update left lateral gaps whenever the pixel footprint (z/f)
  // exceeded the voxel size — low-res depth then produced no complete
  // marching cells at all.
  std::unordered_map<BlockKey, Block*, BlockHash> touched;
  const float bsz = vs * BLOCK;
  for (int py = 0; py < height; py++) {
    for (int px = 0; px < width; px++) {
      float d = depth[py * width + px];
      if (d <= 0 || d > depth_trunc) continue;
      // pad the band by one block so boundary cells get 8 neighbors
      for (float off = -tr - bsz; off <= tr + bsz; off += vs) {
        float z = d + off;
        if (z <= 0.05f) continue;
        float xc = (px - cx) / fx * z, yc = (py - cy) / fy * z;
        float wx = c2w[0] * xc + c2w[1] * yc + c2w[2] * z + c2w[3];
        float wy = c2w[4] * xc + c2w[5] * yc + c2w[6] * z + c2w[7];
        float wz = c2w[8] * xc + c2w[9] * yc + c2w[10] * z + c2w[11];
        BlockKey k{(int32_t)std::floor(wx / bsz),
                   (int32_t)std::floor(wy / bsz),
                   (int32_t)std::floor(wz / bsz)};
        if (touched.count(k)) continue;
        auto it = vol.blocks.find(k);
        if (it == vol.blocks.end())
          it = vol.blocks.emplace(k, new Block()).first;
        touched.emplace(k, it->second);
      }
    }
  }

  for (auto& kv : touched) {
    const BlockKey& k = kv.first;
    Block* blk = kv.second;
    for (int lz = 0; lz < BLOCK; lz++) {
      for (int ly = 0; ly < BLOCK; ly++) {
        for (int lx = 0; lx < BLOCK; lx++) {
          float cxw = (k.x * BLOCK + lx + 0.5f) * vs;
          float cyw = (k.y * BLOCK + ly + 0.5f) * vs;
          float czw = (k.z * BLOCK + lz + 0.5f) * vs;
          float qx = R[0] * cxw + R[1] * cyw + R[2] * czw + t[0];
          float qy = R[3] * cxw + R[4] * cyw + R[5] * czw + t[1];
          float qz = R[6] * cxw + R[7] * cyw + R[8] * czw + t[2];
          if (qz <= 0.05f) continue;
          int ui = (int)std::lround(qx / qz * fx + cx);
          int vi = (int)std::lround(qy / qz * fy + cy);
          if (ui < 0 || ui >= width || vi < 0 || vi >= height) continue;
          float dm = depth[vi * width + ui];
          if (dm <= 0 || dm > depth_trunc) continue;
          float sdf = dm - qz;
          if (sdf < -tr) continue;
          float tsdf = sdf > tr ? 1.0f : sdf / tr;
          Voxel* vox = &blk->v[(lz * BLOCK + ly) * BLOCK + lx];
          float w0 = vox->weight, w1 = w0 + 1.0f;
          vox->tsdf = (vox->tsdf * w0 + tsdf) / w1;
          const float* c = &color[(vi * width + ui) * 3];
          vox->r = (vox->r * w0 + c[0]) / w1;
          vox->g = (vox->g * w0 + c[1]) / w1;
          vox->b = (vox->b * w0 + c[2]) / w1;
          vox->weight = w1;
        }
      }
    }
  }
}

namespace {

struct MeshOut {
  std::vector<float> verts;   // xyz rgb interleaved (6 floats)
  std::vector<int32_t> tris;
};

// the 6-tetrahedra decomposition of a cube (corner indices 0..7,
// corner i at offset (i&1, (i>>1)&1, (i>>2)&1))
constexpr int TETS[6][4] = {{0, 5, 1, 6}, {0, 1, 3, 6}, {0, 3, 2, 6},
                            {0, 2, 6, 4}, {5, 0, 4, 6}, {5, 4, 0, 6}};
// wait-free edge interpolation cache would be nicer; keep it simple.

inline void emit_tet(MeshOut& out, const float p[8][3], const float f[8],
                     const float col[8][3], const int tet[4]) {
  int neg[4], pos[4], nn = 0, np = 0;
  for (int i = 0; i < 4; i++) {
    if (f[tet[i]] < 0) neg[nn++] = tet[i];
    else pos[np++] = tet[i];
  }
  if (nn == 0 || nn == 4) return;

  auto lerp_vert = [&](int a, int b) {
    float fa = f[a], fb = f[b];
    float s = fa / (fa - fb);
    int base = (int)out.verts.size() / 6;
    for (int k = 0; k < 3; k++)
      out.verts.push_back(p[a][k] + s * (p[b][k] - p[a][k]));
    for (int k = 0; k < 3; k++)
      out.verts.push_back(col[a][k] + s * (col[b][k] - col[a][k]));
    return base;
  };

  if (nn == 1) {
    int a = neg[0];
    int v0 = lerp_vert(a, pos[0]), v1 = lerp_vert(a, pos[1]),
        v2 = lerp_vert(a, pos[2]);
    out.tris.insert(out.tris.end(), {v0, v1, v2});
  } else if (nn == 3) {
    int a = pos[0];
    int v0 = lerp_vert(neg[0], a), v1 = lerp_vert(neg[1], a),
        v2 = lerp_vert(neg[2], a);
    out.tris.insert(out.tris.end(), {v0, v1, v2});
  } else {  // 2-2: quad
    int a0 = neg[0], a1 = neg[1], b0 = pos[0], b1 = pos[1];
    int v00 = lerp_vert(a0, b0), v01 = lerp_vert(a0, b1),
        v10 = lerp_vert(a1, b0), v11 = lerp_vert(a1, b1);
    out.tris.insert(out.tris.end(), {v00, v01, v11});
    out.tris.insert(out.tris.end(), {v00, v11, v10});
  }
}

}  // namespace

// Extract the zero isosurface. Returns an opaque mesh handle; query
// sizes then copy out.
void* tsdf_extract_mesh(void* h, float min_weight) {
  Volume& vol = *(Volume*)h;
  auto* out = new MeshOut();
  const float vs = vol.voxel_size;

  float p[8][3], f[8], col[8][3];
  for (auto& kv : vol.blocks) {
    const BlockKey& bk = kv.first;
    for (int lz = 0; lz < BLOCK; lz++)
      for (int ly = 0; ly < BLOCK; ly++)
        for (int lx = 0; lx < BLOCK; lx++) {
          int32_t vx = bk.x * BLOCK + lx, vy = bk.y * BLOCK + ly,
                  vz = bk.z * BLOCK + lz;
          bool ok = true;
          for (int c = 0; c < 8 && ok; c++) {
            Voxel* vox = vol.find(vx + (c & 1), vy + ((c >> 1) & 1),
                                  vz + ((c >> 2) & 1));
            if (!vox || vox->weight < min_weight) {
              ok = false;
              break;
            }
            f[c] = vox->tsdf;
            p[c][0] = (vx + (c & 1) + 0.5f) * vs;
            p[c][1] = (vy + ((c >> 1) & 1) + 0.5f) * vs;
            p[c][2] = (vz + ((c >> 2) & 1) + 0.5f) * vs;
            col[c][0] = vox->r;
            col[c][1] = vox->g;
            col[c][2] = vox->b;
          }
          if (!ok) continue;
          for (const auto& tet : TETS) emit_tet(*out, p, f, col, tet);
        }
  }
  return out;
}

int64_t mesh_num_vertices(void* m) { return (int64_t)((MeshOut*)m)->verts.size() / 6; }
int64_t mesh_num_triangles(void* m) { return (int64_t)((MeshOut*)m)->tris.size() / 3; }

void mesh_copy(void* m, float* verts, int32_t* tris) {
  auto* out = (MeshOut*)m;
  std::memcpy(verts, out->verts.data(), out->verts.size() * sizeof(float));
  std::memcpy(tris, out->tris.data(), out->tris.size() * sizeof(int32_t));
}

void mesh_destroy(void* m) { delete (MeshOut*)m; }

}  // extern "C"
