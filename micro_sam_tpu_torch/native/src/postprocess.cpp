// Native postprocessing ops for micro_sam_tpu (nifty/vigra replacement surface).
//
// Exposed via a plain C ABI consumed through ctypes (micro_sam_tpu/native/__init__.py):
//   - label_multilabel_2d: connected components that respect input label
//     boundaries (two touching regions with different ids stay separate)
//   - seeded_watershed_2d / _3d: priority-flood watershed from integer seeds
//     on a float heightmap restricted to a mask
//   - rle_encode_colmajor: COCO-style column-major run-length encoding
//   - greedy_multicut: additive edge contraction for the 3d merging graph
//
// Build: python -m micro_sam_tpu.native.build  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>
#include <unordered_map>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find connected components over (label, 4-adjacency) for 2d arrays.
// Output ids are consecutive starting at 1; 0 stays background.
// ---------------------------------------------------------------------------

static int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
        int64_t next = parent[x];
        parent[x] = root;
        x = next;
    }
    return root;
}

int64_t label_multilabel_2d(const uint32_t* seg, uint32_t* out,
                            int64_t h, int64_t w) {
    const int64_t n = h * w;
    std::vector<int64_t> parent(n);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;

    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = y * w + x;
            const uint32_t v = seg[i];
            if (v == 0) continue;
            if (x + 1 < w && seg[i + 1] == v) {
                int64_t a = uf_find(parent, i), b = uf_find(parent, i + 1);
                if (a != b) parent[std::max(a, b)] = std::min(a, b);
            }
            if (y + 1 < h && seg[i + w] == v) {
                int64_t a = uf_find(parent, i), b = uf_find(parent, i + w);
                if (a != b) parent[std::max(a, b)] = std::min(a, b);
            }
        }
    }

    std::unordered_map<int64_t, uint32_t> remap;
    remap.reserve(1024);
    uint32_t next_id = 1;
    for (int64_t i = 0; i < n; ++i) {
        if (seg[i] == 0) { out[i] = 0; continue; }
        int64_t root = uf_find(parent, i);
        auto it = remap.find(root);
        if (it == remap.end()) {
            remap.emplace(root, next_id);
            out[i] = next_id++;
        } else {
            out[i] = it->second;
        }
    }
    return static_cast<int64_t>(next_id - 1);
}

// ---------------------------------------------------------------------------
// Seeded watershed (priority flood) on a float32 heightmap.
// seeds: uint32 labels (0 = unlabeled), mask: uint8 (0 = excluded).
// In/out: seeds buffer is extended in place (pass a copy from python).
// ---------------------------------------------------------------------------

struct WsEntry {
    float height;
    uint64_t order;
    int64_t idx;
    uint32_t label;
};

struct WsCompare {
    bool operator()(const WsEntry& a, const WsEntry& b) const {
        if (a.height != b.height) return a.height > b.height;   // min-heap
        return a.order > b.order;                                // FIFO tiebreak
    }
};

void seeded_watershed_2d(const float* height, uint32_t* labels,
                         const uint8_t* mask, int64_t h, int64_t w) {
    const int64_t n = h * w;
    std::vector<uint8_t> visited(n, 0);
    std::priority_queue<WsEntry, std::vector<WsEntry>, WsCompare> heap;
    uint64_t order = 0;

    auto push_neighbors = [&](int64_t idx, uint32_t lbl) {
        const int64_t y = idx / w, x = idx % w;
        const int64_t nbs[4] = {
            (y > 0) ? idx - w : -1,
            (y + 1 < h) ? idx + w : -1,
            (x > 0) ? idx - 1 : -1,
            (x + 1 < w) ? idx + 1 : -1,
        };
        for (int k = 0; k < 4; ++k) {
            const int64_t nb = nbs[k];
            if (nb < 0 || visited[nb] || !mask[nb] || labels[nb] != 0) continue;
            heap.push({height[nb], order++, nb, lbl});
        }
    };

    for (int64_t i = 0; i < n; ++i) {
        if (labels[i] != 0) {
            visited[i] = 1;
            push_neighbors(i, labels[i]);
        } else if (!mask[i]) {
            visited[i] = 1;
        }
    }

    while (!heap.empty()) {
        WsEntry e = heap.top();
        heap.pop();
        if (visited[e.idx]) continue;
        visited[e.idx] = 1;
        labels[e.idx] = e.label;
        push_neighbors(e.idx, e.label);
    }
}

void seeded_watershed_3d(const float* height, uint32_t* labels,
                         const uint8_t* mask, int64_t d, int64_t h, int64_t w) {
    const int64_t n = d * h * w;
    const int64_t hw = h * w;
    std::vector<uint8_t> visited(n, 0);
    std::priority_queue<WsEntry, std::vector<WsEntry>, WsCompare> heap;
    uint64_t order = 0;

    auto push_neighbors = [&](int64_t idx, uint32_t lbl) {
        const int64_t z = idx / hw, rem = idx % hw;
        const int64_t y = rem / w, x = rem % w;
        const int64_t nbs[6] = {
            (z > 0) ? idx - hw : -1,
            (z + 1 < d) ? idx + hw : -1,
            (y > 0) ? idx - w : -1,
            (y + 1 < h) ? idx + w : -1,
            (x > 0) ? idx - 1 : -1,
            (x + 1 < w) ? idx + 1 : -1,
        };
        for (int k = 0; k < 6; ++k) {
            const int64_t nb = nbs[k];
            if (nb < 0 || visited[nb] || !mask[nb] || labels[nb] != 0) continue;
            heap.push({height[nb], order++, nb, lbl});
        }
    };

    for (int64_t i = 0; i < n; ++i) {
        if (labels[i] != 0) {
            visited[i] = 1;
            push_neighbors(i, labels[i]);
        } else if (!mask[i]) {
            visited[i] = 1;
        }
    }

    while (!heap.empty()) {
        WsEntry e = heap.top();
        heap.pop();
        if (visited[e.idx]) continue;
        visited[e.idx] = 1;
        labels[e.idx] = e.label;
        push_neighbors(e.idx, e.label);
    }
}

// ---------------------------------------------------------------------------
// Column-major (Fortran) RLE, counts starting with the zero run (COCO layout).
// counts buffer must have room for h*w + 2 entries. Returns #counts.
// ---------------------------------------------------------------------------

int64_t rle_encode_colmajor(const uint8_t* mask, int64_t* counts,
                            int64_t h, int64_t w) {
    int64_t n_counts = 0;
    uint8_t current = 0;  // runs start with zeros
    int64_t run = 0;
    for (int64_t x = 0; x < w; ++x) {
        for (int64_t y = 0; y < h; ++y) {
            const uint8_t v = mask[y * w + x] ? 1 : 0;
            if (v == current) {
                ++run;
            } else {
                counts[n_counts++] = run;
                current = v;
                run = 1;
            }
        }
    }
    counts[n_counts++] = run;
    return n_counts;
}

// ---------------------------------------------------------------------------
// Greedy additive edge contraction (multicut decomposition heuristic).
// uv_ids: (n_edges, 2) int64; costs: float64 (positive = attractive).
// node_labels out: int64 (n_nodes), consecutive from 0.
// ---------------------------------------------------------------------------

void greedy_multicut(int64_t n_nodes, const int64_t* uv_ids, const double* costs,
                     int64_t n_edges, int64_t* node_labels) {
    std::vector<int64_t> parent(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

    // aggregate duplicate edges
    struct Edge { int64_t u, v; double cost; };
    std::unordered_map<uint64_t, double> edge_costs;
    edge_costs.reserve(n_edges * 2);
    auto key_of = [](int64_t a, int64_t b) {
        if (a > b) std::swap(a, b);
        return (static_cast<uint64_t>(a) << 32) | static_cast<uint64_t>(b);
    };
    for (int64_t e = 0; e < n_edges; ++e) {
        edge_costs[key_of(uv_ids[2 * e], uv_ids[2 * e + 1])] += costs[e];
    }

    // max-heap of attractive edges
    struct HeapEdge {
        double cost;
        int64_t u, v;
        bool operator<(const HeapEdge& o) const { return cost < o.cost; }
    };
    std::priority_queue<HeapEdge> heap;
    for (auto& kv : edge_costs) {
        if (kv.second > 0) {
            heap.push({kv.second,
                       static_cast<int64_t>(kv.first >> 32),
                       static_cast<int64_t>(kv.first & 0xffffffffULL)});
        }
    }

    // lazy contraction: re-evaluate cluster-to-cluster cost on pop
    while (!heap.empty()) {
        HeapEdge e = heap.top();
        heap.pop();
        int64_t ru = uf_find(parent, e.u), rv = uf_find(parent, e.v);
        if (ru == rv) continue;
        // recompute current cost between the two clusters
        double total = 0;
        for (auto& kv : edge_costs) {
            int64_t a = static_cast<int64_t>(kv.first >> 32);
            int64_t b = static_cast<int64_t>(kv.first & 0xffffffffULL);
            int64_t ra = uf_find(parent, a), rb = uf_find(parent, b);
            if ((ra == ru && rb == rv) || (ra == rv && rb == ru)) total += kv.second;
        }
        if (total <= 0) continue;
        parent[std::max(ru, rv)] = std::min(ru, rv);
    }

    std::unordered_map<int64_t, int64_t> remap;
    int64_t next_id = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t root = uf_find(parent, i);
        auto it = remap.find(root);
        if (it == remap.end()) {
            remap.emplace(root, next_id);
            node_labels[i] = next_id++;
        } else {
            node_labels[i] = it->second;
        }
    }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// RLE directly from an MSB-first packed bitstream (COCO layout: runs start
// with zeros). Used by the AMG device pipeline: masks are transposed and
// bit-packed on the TPU so the packed bytes are already in Fortran order.
// counts must have room for n_bits + 2 entries. Returns #counts.
// ---------------------------------------------------------------------------

int64_t rle_encode_packed(const uint8_t* bits, int64_t n_bits, int64_t* counts) {
    int64_t n_counts = 0;
    uint8_t current = 0;
    int64_t run = 0;
    const int64_t n_bytes = n_bits / 8;
    for (int64_t i = 0; i < n_bytes; ++i) {
        const uint8_t byte = bits[i];
        if (byte == 0x00 && current == 0) { run += 8; continue; }
        if (byte == 0xFF && current == 1) { run += 8; continue; }
        for (int b = 7; b >= 0; --b) {
            const uint8_t v = (byte >> b) & 1;
            if (v == current) {
                ++run;
            } else {
                counts[n_counts++] = run;
                current = v;
                run = 1;
            }
        }
    }
    for (int64_t i = n_bytes * 8; i < n_bits; ++i) {
        const uint8_t v = (bits[i / 8] >> (7 - (i % 8))) & 1;
        if (v == current) { ++run; } else { counts[n_counts++] = run; current = v; run = 1; }
    }
    counts[n_counts++] = run;
    return n_counts;
}

// ---------------------------------------------------------------------------
// RLE of a FULL (height H, width W) Fortran-order frame from a packed crop.
// The crop is (crop_w columns x crop_h bits), transposed + bit-packed exactly
// like rle_encode_packed's input but per COLUMN: column c lives at
// packed + c * ceil(crop_h/8), MSB-first, per-column pad bits ignored.
// The crop sits at (x0, y0) in the full frame; everything outside is zero.
// Used by the AMG device pipeline's compacted transfer: only a bbox-sized
// window of each surviving mask crosses the host link, and this encoder
// emits the full-frame COCO counts directly (zero gaps between columns are
// merged on the fly, so no host-side mask reconstruction is needed).
// counts must have room for crop_h*crop_w + 2*crop_w + 4 entries.
// ---------------------------------------------------------------------------

int64_t rle_encode_packed_cropped(
    const uint8_t* packed, int64_t crop_w, int64_t crop_h,
    int64_t x0, int64_t y0, int64_t H, int64_t W, int64_t* counts) {
    int64_t n_counts = 0;
    uint8_t current = 0;
    int64_t run = x0 * H + y0;  // zeros before the first crop-column segment
    const int64_t stride = (crop_h + 7) / 8;
    const int64_t gap = H - crop_h;  // zeros between consecutive crop columns
    const int64_t full_bytes = crop_h / 8;
    for (int64_t c = 0; c < crop_w; ++c) {
        const uint8_t* col = packed + c * stride;
        for (int64_t i = 0; i < full_bytes; ++i) {
            const uint8_t byte = col[i];
            if (byte == 0x00 && current == 0) { run += 8; continue; }
            if (byte == 0xFF && current == 1) { run += 8; continue; }
            for (int b = 7; b >= 0; --b) {
                const uint8_t v = (byte >> b) & 1;
                if (v == current) { ++run; }
                else { counts[n_counts++] = run; current = v; run = 1; }
            }
        }
        for (int64_t i = full_bytes * 8; i < crop_h; ++i) {
            const uint8_t v = (col[i / 8] >> (7 - (i % 8))) & 1;
            if (v == current) { ++run; }
            else { counts[n_counts++] = run; current = v; run = 1; }
        }
        if (c + 1 < crop_w && gap > 0) {
            if (current == 0) { run += gap; }
            else { counts[n_counts++] = run; current = 0; run = gap; }
        }
    }
    const int64_t tail = (H - y0 - crop_h) + (W - x0 - crop_w) * H;
    if (tail > 0) {
        if (current == 0) { run += tail; }
        else { counts[n_counts++] = run; current = 0; run = tail; }
    }
    counts[n_counts++] = run;
    return n_counts;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multithreaded ops (std::thread). The watershed here is the classic
// union-find-on-sorted-pixels algorithm (vigra-style): pixels are processed
// in ascending (height, index) order and joined to already-processed
// neighbors; differently-seeded regions never merge. The order is fully
// deterministic, so the output is IDENTICAL for any thread count — the
// parallelism is in the radix sort and the scatter passes.
// ---------------------------------------------------------------------------

#include <thread>
#include <atomic>

namespace {

inline uint32_t float_sortable(float f) {
    uint32_t b;
    std::memcpy(&b, &f, 4);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

inline int32_t uf_find32(int32_t* parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

inline int64_t clamp_threads(int64_t n_threads) {
    int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (hw <= 0) hw = 1;
    if (n_threads <= 0 || n_threads > hw) n_threads = hw;
    return n_threads;
}

template <typename F>
void parallel_for_chunks(int64_t n, int64_t n_threads, F&& body) {
    // body(thread_id, begin, end)
    if (n_threads <= 1 || n < (1 << 14)) {
        body(0, 0, n);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk, e = std::min(n, b + chunk);
        if (b >= e) break;
        threads.emplace_back([&body, t, b, e]() { body(t, b, e); });
    }
    for (auto& th : threads) th.join();
}

// parallel stable LSD radix sort of 64-bit keys, 4 passes x 16 bits
void radix_sort_u64_parallel(std::vector<uint64_t>& keys, int64_t n_threads) {
    const int64_t n = static_cast<int64_t>(keys.size());
    if (n < 2) return;
    std::vector<uint64_t> tmp(n);
    const int64_t kRadix = 1 << 16;
    const int64_t chunk = (n + n_threads - 1) / n_threads;

    uint64_t* src = keys.data();
    uint64_t* dst = tmp.data();
    std::vector<int64_t> hist(n_threads * kRadix);

    // only the height bits (63..32) need sorting: the array starts in index
    // order and LSD stability keeps that order within equal heights
    for (int pass = 2; pass < 4; ++pass) {
        const int shift = pass * 16;
        std::fill(hist.begin(), hist.end(), 0);
        parallel_for_chunks(n, n_threads, [&](int64_t t, int64_t b, int64_t e) {
            int64_t* h = hist.data() + t * kRadix;
            for (int64_t i = b; i < e; ++i)
                ++h[(src[i] >> shift) & 0xffff];
        });
        // exclusive scan: digit-major over threads preserves stability
        int64_t total = 0;
        for (int64_t d = 0; d < kRadix; ++d) {
            for (int64_t t = 0; t < n_threads; ++t) {
                int64_t& c = hist[t * kRadix + d];
                const int64_t cnt = c;
                c = total;
                total += cnt;
            }
        }
        parallel_for_chunks(n, n_threads, [&](int64_t t, int64_t b, int64_t e) {
            int64_t* h = hist.data() + t * kRadix;
            for (int64_t i = b; i < e; ++i)
                dst[h[(src[i] >> shift) & 0xffff]++] = src[i];
        });
        std::swap(src, dst);
    }
    // 2 passes of even count: data ends up back in keys
    (void)chunk;
}

}  // namespace

extern "C" {

// Union-find watershed on sorted pixels. labels holds the seeds on input
// (0 = unlabeled) and the watershed result on output. mask: 0 = excluded.
// Deterministic for any n_threads (pass 0/negative for all cores).
void watershed_unionfind_2d(const float* height, uint32_t* labels,
                            const uint8_t* mask, int64_t h, int64_t w,
                            int64_t n_threads) {
    const int64_t n = h * w;
    n_threads = clamp_threads(n_threads);

    // collect masked, unseeded pixels as sortable (height, index) keys
    std::vector<int64_t> counts(n_threads + 1, 0);
    parallel_for_chunks(n, n_threads, [&](int64_t t, int64_t b, int64_t e) {
        int64_t c = 0;
        for (int64_t i = b; i < e; ++i)
            c += (mask[i] && labels[i] == 0);
        counts[t + 1] = c;
    });
    for (int64_t t = 0; t < n_threads; ++t) counts[t + 1] += counts[t];
    std::vector<uint64_t> keys(counts[n_threads]);
    parallel_for_chunks(n, n_threads, [&](int64_t t, int64_t b, int64_t e) {
        int64_t pos = counts[t];
        for (int64_t i = b; i < e; ++i) {
            if (mask[i] && labels[i] == 0)
                keys[pos++] = (static_cast<uint64_t>(float_sortable(height[i])) << 32)
                              | static_cast<uint64_t>(i);
        }
    });

    radix_sort_u64_parallel(keys, n_threads);

    // union-find pass: sequential by construction (the order IS the result)
    std::vector<int32_t> parent(n);
    std::vector<uint8_t> active(n, 0);
    std::vector<uint32_t> root_label(n, 0);
    parallel_for_chunks(n, n_threads, [&](int64_t, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            parent[i] = static_cast<int32_t>(i);
            if (labels[i] != 0) {
                active[i] = 1;
                root_label[i] = labels[i];
            }
        }
    });

    // Labeled components never union (same label: no-op; different: boundary),
    // so union-find work only happens for unlabeled pools: the common case is
    // a direct labels[] read + write, no find.
    for (uint64_t key : keys) {
        const int64_t p = static_cast<int64_t>(key & 0xffffffffULL);
        const int64_t y = p / w, x = p % w;
        active[p] = 1;
        const int64_t nbs[4] = {
            (y > 0) ? p - w : -1,
            (x > 0) ? p - 1 : -1,
            (x + 1 < w) ? p + 1 : -1,
            (y + 1 < h) ? p + w : -1,
        };
        uint32_t cur = 0;
        int32_t joined_root = -1;
        for (int k = 0; k < 4; ++k) {
            const int64_t q = nbs[k];
            if (q < 0 || !active[q] || !mask[q]) continue;
            uint32_t qlab = labels[q];
            if (qlab == 0) {
                const int32_t rq = uf_find32(parent.data(), static_cast<int32_t>(q));
                qlab = root_label[rq];
                if (qlab == 0) {  // truly unlabeled pool
                    if (cur != 0) {
                        root_label[rq] = cur;  // pool adopts p's label
                    } else if (joined_root == -1) {
                        joined_root = rq;
                    } else {
                        const int32_t jr = uf_find32(parent.data(), joined_root);
                        if (jr != rq) {
                            const int32_t keep = std::min(jr, rq);
                            parent[std::max(jr, rq)] = keep;
                            joined_root = keep;
                        }
                    }
                    continue;
                }
            }
            if (cur == 0) {
                cur = qlab;  // first labeled neighbor wins (fixed order)
                if (joined_root != -1) {
                    root_label[uf_find32(parent.data(), joined_root)] = cur;
                    joined_root = -1;
                }
            }
            // else: second label -> watershed boundary, skip
        }
        if (cur != 0) {
            labels[p] = cur;
            root_label[p] = cur;  // p stays a labeled singleton
        } else if (joined_root != -1) {
            parent[p] = joined_root;  // p joins the unlabeled pool
        }
    }

    parallel_for_chunks(n, n_threads, [&](int64_t, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            if (mask[i] && labels[i] == 0) {
                int32_t r = static_cast<int32_t>(i);
                while (parent[r] != r) r = parent[r];  // read-only find
                labels[i] = root_label[r];
            }
        }
    });
}

// 3d variant (6-adjacency), same algorithm.
void watershed_unionfind_3d(const float* height, uint32_t* labels,
                            const uint8_t* mask, int64_t d, int64_t h, int64_t w,
                            int64_t n_threads) {
    const int64_t hw = h * w;
    const int64_t n = d * hw;
    n_threads = clamp_threads(n_threads);

    std::vector<int64_t> counts(n_threads + 1, 0);
    parallel_for_chunks(n, n_threads, [&](int64_t t, int64_t b, int64_t e) {
        int64_t c = 0;
        for (int64_t i = b; i < e; ++i)
            c += (mask[i] && labels[i] == 0);
        counts[t + 1] = c;
    });
    for (int64_t t = 0; t < n_threads; ++t) counts[t + 1] += counts[t];
    std::vector<uint64_t> keys(counts[n_threads]);
    parallel_for_chunks(n, n_threads, [&](int64_t t, int64_t b, int64_t e) {
        int64_t pos = counts[t];
        for (int64_t i = b; i < e; ++i) {
            if (mask[i] && labels[i] == 0)
                keys[pos++] = (static_cast<uint64_t>(float_sortable(height[i])) << 32)
                              | static_cast<uint64_t>(i);
        }
    });
    radix_sort_u64_parallel(keys, n_threads);

    // union-find pass (see 2d)
    std::vector<int32_t> parent(n);
    std::vector<uint8_t> active(n, 0);
    std::vector<uint32_t> root_label(n, 0);
    parallel_for_chunks(n, n_threads, [&](int64_t, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            parent[i] = static_cast<int32_t>(i);
            if (labels[i] != 0) {
                active[i] = 1;
                root_label[i] = labels[i];
            }
        }
    });

    // Labeled components never union (same label: no-op; different: boundary),
    // so union-find work only happens for unlabeled pools: the common case is
    // a direct labels[] read + write, no find.
    for (uint64_t key : keys) {
        const int64_t p = static_cast<int64_t>(key & 0xffffffffULL);
        const int64_t z = p / hw, rem = p % hw;
        const int64_t y = rem / w, x = rem % w;
        active[p] = 1;
        const int64_t nbs[6] = {
            (z > 0) ? p - hw : -1,
            (y > 0) ? p - w : -1,
            (x > 0) ? p - 1 : -1,
            (x + 1 < w) ? p + 1 : -1,
            (y + 1 < h) ? p + w : -1,
            (z + 1 < d) ? p + hw : -1,
        };
        uint32_t cur = 0;
        int32_t joined_root = -1;
        for (int k = 0; k < 6; ++k) {
            const int64_t q = nbs[k];
            if (q < 0 || !active[q] || !mask[q]) continue;
            uint32_t qlab = labels[q];
            if (qlab == 0) {
                const int32_t rq = uf_find32(parent.data(), static_cast<int32_t>(q));
                qlab = root_label[rq];
                if (qlab == 0) {  // truly unlabeled pool
                    if (cur != 0) {
                        root_label[rq] = cur;  // pool adopts p's label
                    } else if (joined_root == -1) {
                        joined_root = rq;
                    } else {
                        const int32_t jr = uf_find32(parent.data(), joined_root);
                        if (jr != rq) {
                            const int32_t keep = std::min(jr, rq);
                            parent[std::max(jr, rq)] = keep;
                            joined_root = keep;
                        }
                    }
                    continue;
                }
            }
            if (cur == 0) {
                cur = qlab;  // first labeled neighbor wins (fixed order)
                if (joined_root != -1) {
                    root_label[uf_find32(parent.data(), joined_root)] = cur;
                    joined_root = -1;
                }
            }
            // else: second label -> watershed boundary, skip
        }
        if (cur != 0) {
            labels[p] = cur;
            root_label[p] = cur;  // p stays a labeled singleton
        } else if (joined_root != -1) {
            parent[p] = joined_root;  // p joins the unlabeled pool
        }
    }

    parallel_for_chunks(n, n_threads, [&](int64_t, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) {
            if (mask[i] && labels[i] == 0) {
                int32_t r = static_cast<int32_t>(i);
                while (parent[r] != r) r = parent[r];
                labels[i] = root_label[r];
            }
        }
    });
}

// Strip-parallel connected components over (label, 4-adjacency): each thread
// unions edges fully inside its row strip (disjoint index ranges -> safe),
// then the strip-boundary rows are merged serially. Output matches the
// single-threaded label_multilabel_2d exactly (ids relabeled in scan order).
int64_t label_multilabel_2d_par(const uint32_t* seg, uint32_t* out,
                                int64_t h, int64_t w, int64_t n_threads) {
    const int64_t n = h * w;
    n_threads = clamp_threads(n_threads);
    std::vector<int64_t> parent(n);
    parallel_for_chunks(n, n_threads, [&](int64_t, int64_t b, int64_t e) {
        for (int64_t i = b; i < e; ++i) parent[i] = i;
    });

    const int64_t rows_per = (h + n_threads - 1) / n_threads;
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        const int64_t y0 = t * rows_per, y1 = std::min(h, y0 + rows_per);
        if (y0 >= y1) break;
        threads.emplace_back([&, y0, y1]() {
            for (int64_t y = y0; y < y1; ++y) {
                for (int64_t x = 0; x < w; ++x) {
                    const int64_t i = y * w + x;
                    const uint32_t v = seg[i];
                    if (v == 0) continue;
                    if (x + 1 < w && seg[i + 1] == v) {
                        int64_t a = uf_find(parent, i), b = uf_find(parent, i + 1);
                        if (a != b) parent[std::max(a, b)] = std::min(a, b);
                    }
                    if (y + 1 < y1 && seg[i + w] == v) {
                        int64_t a = uf_find(parent, i), b = uf_find(parent, i + w);
                        if (a != b) parent[std::max(a, b)] = std::min(a, b);
                    }
                }
            }
        });
    }
    for (auto& th : threads) th.join();

    // serial pass over strip-boundary rows
    for (int64_t t = 1; t < n_threads; ++t) {
        const int64_t y = t * rows_per;
        if (y <= 0 || y >= h) continue;
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = (y - 1) * w + x;
            const uint32_t v = seg[i];
            if (v == 0 || seg[i + w] != v) continue;
            int64_t a = uf_find(parent, i), b = uf_find(parent, i + w);
            if (a != b) parent[std::max(a, b)] = std::min(a, b);
        }
    }

    std::unordered_map<int64_t, uint32_t> remap;
    remap.reserve(1024);
    uint32_t next_id = 1;
    for (int64_t i = 0; i < n; ++i) {
        if (seg[i] == 0) { out[i] = 0; continue; }
        int64_t root = uf_find(parent, i);
        auto it = remap.find(root);
        if (it == remap.end()) {
            remap.emplace(root, next_id);
            out[i] = next_id++;
        } else {
            out[i] = it->second;
        }
    }
    return static_cast<int64_t>(next_id - 1);
}

}  // extern "C"
