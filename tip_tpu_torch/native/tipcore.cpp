// tipcore: the host loops of the port's graph packing, in C++.
//
// The port's copy of the JAX package's native packing library, with the
// same four C functions and the same results: edge sort by (et, dst, src),
// membership-bitmap build, chunk-aligned padded fill and in-degree count.
// tip_tpu_torch/native/__init__.py builds it with
//   g++ -O3 -shared -fPIC tipcore.cpp -o libtipcore.so
// at first use and binds it with ctypes; the numpy version of each
// function sits beside its binding there (tests/test_torch_native.py holds
// the two bit for bit).
// ABI: plain C functions over caller-allocated buffers.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// Fill `order` with the permutation that sorts the edges by (et, dst, src),
// ties in index order (np.lexsort((src, dst, et))).  Needs 0 <= src, dst <
// n_nodes and et >= 0, so that the key is one-to-one.
void tip_sort_edges(const int32_t* et, const int32_t* dst, const int32_t* src,
                    int64_t n_edges, int64_t n_nodes, int64_t* order) {
  std::vector<std::pair<int64_t, int64_t>> keyed(n_edges);
  for (int64_t i = 0; i < n_edges; ++i) {
    int64_t key = ((int64_t)et[i] * n_nodes + dst[i]) * n_nodes + src[i];
    keyed[i] = {key, i};
  }
  std::sort(keyed.begin(), keyed.end());
  for (int64_t i = 0; i < n_edges; ++i) order[i] = keyed[i].second;
}

// OR each key's bit into a caller-zeroed uint32 bitmap (keys in range).
void tip_build_bitmap(const int64_t* keys, int64_t n_keys, uint32_t* bitmap) {
  for (int64_t i = 0; i < n_keys; ++i) {
    int64_t k = keys[i];
    bitmap[k >> 5] |= (uint32_t)1 << (k & 31);
  }
}

// Chunk-aligned padding of a type-binned edge buffer
// (data/packing.py:pad_typed_edges): relation t's edges [starts[t],
// ends[t]) go to out_starts[t].  psrc pre-zeroed, pdst pre-filled with
// n_nodes, valid pre-zeroed.
void tip_pad_typed(const int32_t* src, const int32_t* dst,
                   const int64_t* starts, const int64_t* ends,
                   const int64_t* out_starts, int64_t n_et,
                   int32_t* psrc, int32_t* pdst, uint8_t* valid) {
  for (int64_t t = 0; t < n_et; ++t) {
    int64_t s = starts[t], n = ends[t] - starts[t], o = out_starts[t];
    std::memcpy(psrc + o, src + s, n * sizeof(int32_t));
    std::memcpy(pdst + o, dst + s, n * sizeof(int32_t));
    std::memset(valid + o, 1, n);
  }
}

// Count of each value of x (all in [0, n)) into a caller-zeroed int64
// buffer of n.
void tip_bincount(const int32_t* x, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[x[i]] += 1;
}

}  // extern "C"
