// Native host runtime of the PyTorch port (ggnn_torch).
//
// Covers the host-side subsystems the reference implements in C++:
//   * blocked TEXMEX .fvecs/.bvecs/.ivecs readers/writer
//     (reference: src/ggnn/base/dataset.cu:118-233)
//   * the multi-threaded per-query k-way top-k merge of per-device partial
//     results (reference: src/ggnn/base/result_merger.cpp:79-148)
//
// Exposed as a plain C ABI consumed via ctypes (ggnn_torch/native/io.py,
// ggnn_torch/native/merge.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

// Return the number of rows in a TEXMEX file and its dimension, or -1 on
// error. Row layout: [int32 dim][dim * elem_size bytes].
int64_t ggnn_vecs_info(const char* path, int64_t elem_size, int64_t* dim_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int32_t dim = 0;
  if (std::fread(&dim, sizeof(int32_t), 1, f) != 1 || dim <= 0) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_END);
  const int64_t file_size = std::ftell(f);
  std::fclose(f);
  const int64_t row_bytes = 4 + static_cast<int64_t>(dim) * elem_size;
  if (file_size % row_bytes) return -1;
  *dim_out = dim;
  return file_size / row_bytes;
}

// Blocked read of [from_row, from_row + num_rows) into `out` (row-major,
// headers stripped). Returns rows read or -1 on error.
int64_t ggnn_read_vecs(const char* path, int64_t elem_size, int64_t from_row,
                       int64_t num_rows, void* out) {
  int64_t dim = 0;
  const int64_t total = ggnn_vecs_info(path, elem_size, &dim);
  if (total < 0 || from_row >= total) return -1;
  num_rows = std::min(num_rows, total - from_row);

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const int64_t row_bytes = 4 + dim * elem_size;
  const int64_t payload = dim * elem_size;

  // read in ~64 MiB blocks, strip headers in-place
  const int64_t rows_per_block = std::max<int64_t>(1, (64 << 20) / row_bytes);
  std::vector<char> buf(static_cast<size_t>(rows_per_block) * row_bytes);
  char* dst = static_cast<char*>(out);

  if (std::fseek(f, from_row * row_bytes, SEEK_SET)) {
    std::fclose(f);
    return -1;
  }
  int64_t done = 0;
  while (done < num_rows) {
    const int64_t n = std::min(rows_per_block, num_rows - done);
    if (std::fread(buf.data(), row_bytes, n, f) != static_cast<size_t>(n)) {
      std::fclose(f);
      return -1;
    }
    for (int64_t r = 0; r < n; ++r) {
      int32_t row_dim;
      std::memcpy(&row_dim, buf.data() + r * row_bytes, 4);
      if (row_dim != dim) {
        std::fclose(f);
        return -1;
      }
      std::memcpy(dst + (done + r) * payload, buf.data() + r * row_bytes + 4,
                  payload);
    }
    done += n;
  }
  std::fclose(f);
  return done;
}

// Write [n, d] row-major data as TEXMEX. Returns rows written or -1.
int64_t ggnn_write_vecs(const char* path, const void* data, int64_t n,
                        int64_t d, int64_t elem_size) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int32_t dim = static_cast<int32_t>(d);
  const int64_t payload = d * elem_size;
  const char* src = static_cast<const char*>(data);
  for (int64_t r = 0; r < n; ++r) {
    if (std::fwrite(&dim, 4, 1, f) != 1 ||
        std::fwrite(src + r * payload, payload, 1, f) != 1) {
      std::fclose(f);
      return -1;
    }
  }
  std::fclose(f);
  return n;
}

namespace {

// One (id, dist) cursor per partition for the k-way merge.
struct HeapEntry {
  int32_t id;
  float dist;
  int32_t partition;
};

void merge_range(const int32_t* ids, const float* dists, int64_t num_parts,
                 int64_t num_queries, int64_t stride, int64_t k_out,
                 int64_t id_offset_scale, int64_t q_begin, int64_t q_end,
                 int32_t* out_ids, float* out_dists) {
  std::vector<HeapEntry> heap;
  std::vector<int64_t> offsets(num_parts);
  // min-heap by (distance, partition): among equal distances the lower
  // partition comes out first, so the merge equals a stable sort of the
  // partitions' rows concatenated in partition order
  auto cmp = [](const HeapEntry& a, const HeapEntry& b) {
    return a.dist > b.dist || (a.dist == b.dist && a.partition > b.partition);
  };
  auto at = [&](int64_t p, int64_t q, int64_t off) {
    return (p * num_queries + q) * stride + off;
  };
  for (int64_t q = q_begin; q < q_end; ++q) {
    heap.clear();
    std::fill(offsets.begin(), offsets.end(), 1);
    for (int64_t p = 0; p < num_parts; ++p) {
      const int64_t a = at(p, q, 0);
      heap.push_back({ids[a], dists[a], static_cast<int32_t>(p)});
    }
    std::make_heap(heap.begin(), heap.end(), cmp);
    for (int64_t k = 0; k < k_out; ++k) {
      const HeapEntry top = heap.front();
      out_ids[q * k_out + k] =
          top.id + static_cast<int32_t>(top.partition * id_offset_scale);
      out_dists[q * k_out + k] = top.dist;
      if (k == k_out - 1) break;
      std::pop_heap(heap.begin(), heap.end(), cmp);
      heap.pop_back();
      const int64_t off = offsets[top.partition]++;
      if (off < stride) {
        const int64_t a = at(top.partition, q, off);
        heap.push_back({ids[a], dists[a], top.partition});
      } else {
        heap.push_back(
            {-1, std::numeric_limits<float>::infinity(), top.partition});
      }
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
  }
}

}  // namespace

// K-way merge of per-partition sorted partial results.
//   ids/dists: [num_parts, num_queries, stride], each row sorted ascending.
//   out: [num_queries, k_out].
//   id_offset_scale: added as partition * scale to returned ids
//     (0 if ids are already global).
void ggnn_merge_topk(const int32_t* ids, const float* dists, int64_t num_parts,
                     int64_t num_queries, int64_t stride, int64_t k_out,
                     int64_t id_offset_scale, int32_t* out_ids,
                     float* out_dists, int64_t num_threads) {
  if (num_threads <= 1 || num_queries < 128) {
    merge_range(ids, dists, num_parts, num_queries, stride, k_out,
                id_offset_scale, 0, num_queries, out_ids, out_dists);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t per = (num_queries + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = std::min(num_queries, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(merge_range, ids, dists, num_parts, num_queries,
                         stride, k_out, id_offset_scale, lo, hi, out_ids,
                         out_dists);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
