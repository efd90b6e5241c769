// Marching-tetrahedra isosurface extraction — native core.
//
// Same algorithm and contract as the numpy fallback
// (vmap_tpu_torch/geometry/marching_cubes.py): 6-tet cube decomposition, 16-case
// per-tet table generated programmatically, inside->outside oriented
// triangles, vertices welded on a 1/1024 grid, output in index coordinates.
// The Python tests cross-check both implementations on identical volumes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libvmapgeom.so marching_cubes.cpp
// (see build.py; loaded via ctypes, no pybind dependency).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Edge { int a, b; };          // local tet vertex indices (inside, outside)
struct Tri { Edge e[3]; };

// cube corner offsets (bit order shared with the Python implementation)
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};
const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// case table: for each 4-bit inside mask, up to 2 triangles of tet edges
struct CaseEntry { int n; Tri t[2]; };

CaseEntry make_case(int cid) {
    int in[4], out[4];
    int ni = 0, no = 0;
    for (int i = 0; i < 4; ++i) {
        if (cid & (1 << i)) in[ni++] = i; else out[no++] = i;
    }
    CaseEntry ce{0, {}};
    if (ni == 0 || ni == 4) return ce;
    if (ni == 1) {
        int a = in[0];
        ce.n = 1;
        ce.t[0] = {{{a, out[0]}, {a, out[1]}, {a, out[2]}}};
    } else if (ni == 3) {
        int a = out[0];
        ce.n = 1;
        ce.t[0] = {{{in[0], a}, {in[2], a}, {in[1], a}}};
    } else {  // two inside
        int a = in[0], b = in[1], c = out[0], d = out[1];
        ce.n = 2;
        ce.t[0] = {{{a, c}, {a, d}, {b, d}}};
        ce.t[1] = {{{a, c}, {b, d}, {b, c}}};
    }
    return ce;
}

struct Key {
    int64_t x, y, z;
    bool operator==(const Key& o) const { return x == o.x && y == o.y && z == o.z; }
};
struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = 1469598103934665603ull;
        auto mix = [&h](uint64_t v) {
            h ^= v; h *= 1099511628211ull;
        };
        mix((uint64_t)k.x); mix((uint64_t)k.y); mix((uint64_t)k.z);
        return (size_t)h;
    }
};

}  // namespace

namespace {

// Emit the triangle soup (9 floats per wound triangle) for x in [x0, x1).
void slab_worker(const float* vol, int64_t nx, int64_t ny, int64_t nz,
                 float level, int64_t x0, int64_t x1,
                 const CaseEntry* cases, std::vector<float>* soup) {
    const int64_t sy = nz;          // stride for y in a [x][y][z] C layout
    const int64_t sx = ny * nz;
    float cpos[8][3];
    float cval[8];

    for (int64_t x = x0; x < x1 && x + 1 < nx; ++x) {
        for (int64_t y = 0; y + 1 < ny; ++y) {
            for (int64_t z = 0; z + 1 < nz; ++z) {
                bool any_in = false, any_out = false;
                for (int c = 0; c < 8; ++c) {
                    const float v = vol[(x + CORNERS[c][0]) * sx +
                                        (y + CORNERS[c][1]) * sy +
                                        (z + CORNERS[c][2])];
                    cval[c] = v;
                    if (v > level) any_in = true; else any_out = true;
                }
                if (!any_in || !any_out) continue;
                for (int c = 0; c < 8; ++c) {
                    cpos[c][0] = (float)(x + CORNERS[c][0]);
                    cpos[c][1] = (float)(y + CORNERS[c][1]);
                    cpos[c][2] = (float)(z + CORNERS[c][2]);
                }
                for (int t = 0; t < 6; ++t) {
                    int cid = 0;
                    for (int i = 0; i < 4; ++i)
                        if (cval[TETS[t][i]] > level) cid |= 1 << i;
                    const CaseEntry& ce = cases[cid];
                    for (int k = 0; k < ce.n; ++k) {
                        float p[3][3];
                        float anchor[3] = {0, 0, 0};
                        for (int e = 0; e < 3; ++e) {
                            const int ia = TETS[t][ce.t[k].e[e].a];
                            const int ib = TETS[t][ce.t[k].e[e].b];
                            const float va = cval[ia], vb = cval[ib];
                            const float tt = (level - va) / (vb - va);
                            for (int d = 0; d < 3; ++d)
                                p[e][d] = cpos[ia][d] + tt * (cpos[ib][d] - cpos[ia][d]);
                            if (e == 0) {
                                const float s = (va > level) ? 1.f : -1.f;
                                for (int d = 0; d < 3; ++d)
                                    anchor[d] = s * (cpos[ib][d] - cpos[ia][d]);
                            }
                        }
                        // consistent winding: normal along inside->outside
                        float u[3], v2[3], n[3];
                        for (int d = 0; d < 3; ++d) {
                            u[d] = p[1][d] - p[0][d];
                            v2[d] = p[2][d] - p[0][d];
                        }
                        n[0] = u[1] * v2[2] - u[2] * v2[1];
                        n[1] = u[2] * v2[0] - u[0] * v2[2];
                        n[2] = u[0] * v2[1] - u[1] * v2[0];
                        const float dot = n[0] * anchor[0] + n[1] * anchor[1]
                                        + n[2] * anchor[2];
                        int order[3] = {0, 1, 2};
                        if (dot < 0) { order[1] = 2; order[2] = 1; }
                        for (int e = 0; e < 3; ++e) {
                            const float* pp = p[order[e]];
                            soup->push_back(pp[0]);
                            soup->push_back(pp[1]);
                            soup->push_back(pp[2]);
                        }
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 on empty level set. Outputs are malloc'd; free
// with mt_free. Extraction parallelises over x-slabs (std::thread); vertex
// welding is a serial hash pass over the merged soup.
int mt_marching_tetrahedra(const float* vol, int64_t nx, int64_t ny, int64_t nz,
                           float level,
                           float** out_verts, int64_t* out_n_verts,
                           int64_t** out_faces, int64_t* out_n_faces) {
    static CaseEntry cases[16];
    static bool init = false;
    if (!init) {
        for (int c = 0; c < 16; ++c) cases[c] = make_case(c);
        init = true;
    }

    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    const int64_t cells_x = nx - 1;
    if (cells_x < n_threads * 4) n_threads = 1;

    std::vector<std::vector<float>> soups(n_threads);
    if (n_threads == 1) {
        slab_worker(vol, nx, ny, nz, level, 0, cells_x, cases, &soups[0]);
    } else {
        std::vector<std::thread> pool;
        const int64_t step = (cells_x + n_threads - 1) / n_threads;
        for (int i = 0; i < n_threads; ++i) {
            const int64_t x0 = i * step;
            const int64_t x1 = x0 + step < cells_x ? x0 + step : cells_x;
            pool.emplace_back(slab_worker, vol, nx, ny, nz, level, x0, x1,
                              cases, &soups[i]);
        }
        for (auto& th : pool) th.join();
    }

    int64_t total = 0;
    for (auto& s : soups) total += (int64_t)s.size();
    if (total == 0) return 1;

    std::vector<float> verts;
    std::vector<int64_t> faces;
    verts.reserve(total / 2);
    faces.reserve(total / 9 * 3);
    std::unordered_map<Key, int64_t, KeyHash> weld;
    weld.reserve((size_t)(total / 6));

    for (auto& s : soups) {
        for (size_t off = 0; off + 9 <= s.size(); off += 9) {
            int64_t idx[3];
            for (int e = 0; e < 3; ++e) {
                const float* pp = &s[off + 3 * (size_t)e];
                Key key{(int64_t)llroundf(pp[0] * 1024.f),
                        (int64_t)llroundf(pp[1] * 1024.f),
                        (int64_t)llroundf(pp[2] * 1024.f)};
                auto it = weld.find(key);
                if (it == weld.end()) {
                    const int64_t vid = (int64_t)(verts.size() / 3);
                    weld.emplace(key, vid);
                    verts.push_back(pp[0]);
                    verts.push_back(pp[1]);
                    verts.push_back(pp[2]);
                    idx[e] = vid;
                } else {
                    idx[e] = it->second;
                }
            }
            if (idx[0] != idx[1] && idx[1] != idx[2] && idx[0] != idx[2]) {
                faces.push_back(idx[0]);
                faces.push_back(idx[1]);
                faces.push_back(idx[2]);
            }
        }
    }

    if (faces.empty()) return 1;
    *out_n_verts = (int64_t)(verts.size() / 3);
    *out_n_faces = (int64_t)(faces.size() / 3);
    *out_verts = (float*)std::malloc(verts.size() * sizeof(float));
    *out_faces = (int64_t*)std::malloc(faces.size() * sizeof(int64_t));
    std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int64_t));
    return 0;
}

void mt_free(void* p) { std::free(p); }

}  // extern "C"
