// Kernel K3: fused multi-row interval sums.
//
// Replaces the Pallas TPU kernel ecckd_tpu/ops/segments.py
// (_interval_sum_fused_pallas, body _isum_pallas_kernel, groups from
// _pallas_groups).  Each output row is the elementwise product of a few
// operand rows ((rows, n) operands contribute their row j, (1, n) operands
// broadcast), summed over every inclusive interval [i1[j], i2[j]].  For the
// LW candidate cost the rows are the fit numerator metric*planck, the fit
// weights planck, the truth heating rates and the two boundary fluxes
// (3*nlay + 2 rows); for the SW total-transmission cost the 2*nlay + 1 flux
// levels, od*ssi and two scaled truth sets (5*nlay + 5 rows).
//
// What bounds it on an H100: device memory.  Each output row costs one or
// two loads and a multiply per wavenumber; at 2^20 x 152 rows in f64 the
// distinct operands are 1.27 GB, read once.
// What the design does about it:
//  * the wrapper resolves the part layout once per parts list into one
//    descriptor per output row: the address of each operand's row (a
//    broadcast operand's only row), the first two inline, any further ones
//    in a list.  A block copies its 8 rows' descriptors into shared memory
//    once, so the streaming loop chases no table;
//  * the streaming and the reduction are those of interval_stream.cuh:
//    16-byte loads of two rows at a time, masked warp sums per strip over
//    the few intervals that meet it, compact per-chunk partials, no
//    atomics.  An operand row shared by two output rows (planck in the LW
//    fit) is read by blocks that run together, the second time from L2.
// The TPU kernel's bf16 split of the membership matmul is not carried over.
#include "interval_stream.cuh"

namespace ecckd {

// One output row: the product a * b * extra[extra_at .. extra_at + nextra)
// of operand rows (b == 0 for a single operand).
struct RowDesc {
  long long a;
  long long b;
  int extra_at;
  int nextra;
};
static_assert(sizeof(RowDesc) == 24, "RowDesc is three 8-byte words");

template <typename T>
struct PartRows {
  static constexpr int kRows = 2;
  static constexpr int kItems = 4;
  const RowDesc* desc;
  const T* const* extra;
  int nrows;
  int nextra;          // entries of ``extra``, for the checked build
  int r0;
  RowDesc* s_desc;

  // The descriptors of the block's rows into shared memory; the streaming
  // kernel's first barrier comes before any thread reads them.
  __device__ void stage(int item0, unsigned char* smem) {
    s_desc = reinterpret_cast<RowDesc*>(smem);
    r0 = item0 * kRows;
    for (int k = threadIdx.x; k < kRows * kItems && r0 + k < nrows;
         k += blockDim.x) {
      ECCKD_CHECK_INDEX("interval_sum", "descriptor", r0 + k, nrows);
      s_desc[k] = desc[r0 + k];
    }
  }

  __device__ int row(int item, int q) const {
    const int r = item * kRows + q;
    return r < nrows ? r : -1;
  }

  __device__ void load(int item, int s0, int n,
                       T (&v)[kRows][stream::kPer<T>]) const {
    constexpr int P = stream::kPer<T>;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = item * kRows + q;
      if (r >= nrows) {
#pragma unroll
        for (int k = 0; k < P; ++k) v[q][k] = T(0);
        continue;
      }
      ECCKD_CHECK_INDEX("interval_sum", "descriptor in shared memory",
                        r - r0, kRows * kItems);
      const RowDesc d = s_desc[r - r0];
      stream::load_strip<T>(reinterpret_cast<const T*>(d.a), s0, n, v[q]);
      if (d.b) {
        T t[P];
        stream::load_strip<T>(reinterpret_cast<const T*>(d.b), s0, n, t);
#pragma unroll
        for (int k = 0; k < P; ++k) v[q][k] = stream::mul(v[q][k], t[k]);
      }
      for (int x = 0; x < d.nextra; ++x) {
        ECCKD_CHECK_INDEX("interval_sum", "extra operand", d.extra_at + x,
                          nextra);
        T t[P];
        stream::load_strip<T>(extra[d.extra_at + x], s0, n, t);
#pragma unroll
        for (int k = 0; k < P; ++k) v[q][k] = stream::mul(v[q][k], t[k]);
      }
    }
  }
};

template <typename T>
int interval_sum(const void* desc, const void* extra, const void* table,
                 void* partial, void* out, int nrows, int n, int nseg,
                 int nentries, int cmax, int nextra, void* stream) {
  using Src = PartRows<T>;
  Src src{static_cast<const RowDesc*>(desc),
          static_cast<const T* const*>(extra), nrows, nextra, 0, nullptr};
  const int rows_per_block = Src::kRows * Src::kItems;
  const int ngroups = (nrows + rows_per_block - 1) / rows_per_block;
  return stream::launch<T>(src, ngroups, static_cast<const int*>(table),
                           nentries, cmax, sizeof(RowDesc) * rows_per_block,
                           static_cast<T*>(partial), static_cast<T*>(out),
                           nrows, n, nseg, static_cast<cudaStream_t>(stream));
}

}  // namespace ecckd

extern "C" {

// Wavenumbers per chunk of the streaming core.
int ecckd_stream_chunk_size() { return ecckd::stream::kChunk; }

// ``desc`` is a device array of one RowDesc per output row (three 8-byte
// words: operand row addresses a, b and extra_at | nextra << 32), ``extra``
// a device array of ``nextra`` further operand row addresses (its length
// is read by the checked build only); ``table`` the int32 interval table
// of interval_stream.cuh with ``nentries`` entries and at most ``cmax`` (1
// to 32) per block pass.  ``out`` is
// (nrows, nseg); ``partial`` scratch of (slots in the table) * nrows
// values.  Returns the CUDA error code of the launches (0 on success).
int ecckd_interval_sum_f64(const void* desc, const void* extra,
                           const void* table, void* partial, void* out,
                           int nrows, int n, int nseg, int nentries, int cmax,
                           int nextra, void* stream) {
  return ecckd::interval_sum<double>(desc, extra, table, partial, out, nrows,
                                     n, nseg, nentries, cmax, nextra, stream);
}

int ecckd_interval_sum_f32(const void* desc, const void* extra,
                           const void* table, void* partial, void* out,
                           int nrows, int n, int nseg, int nentries, int cmax,
                           int nextra, void* stream) {
  return ecckd::interval_sum<float>(desc, extra, table, partial, out, nrows,
                                    n, nseg, nentries, cmax, nextra, stream);
}

}  // extern "C"
