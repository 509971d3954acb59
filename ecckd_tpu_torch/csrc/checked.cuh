// Index checks of the checked build.
//
// ops/kernels/_build.py builds a second library from the same sources with
// -DECCKD_CHECKED=1 -lineinfo (``library(checked=True)``, or the wrappers
// inside ``_build.checked()``).  There every index that a kernel takes from
// a table or an argument is held to its range before use; one outside it
// prints the kernel, the block, the thread, the index and its range, then
// traps, which ends the launch with an error that the next synchronisation
// reports.  The normal build compiles none of the checks.
#pragma once

#include <cstdio>

#if defined(ECCKD_CHECKED) && ECCKD_CHECKED

static __device__ __noinline__ void ecckd_check_failed(const char* kernel,
                                                       const char* what,
                                                       long long index,
                                                       long long lo,
                                                       long long hi) {
  printf("ecckd checked build: %s block (%d, %d) thread %d: %s = %lld "
         "outside [%lld, %lld]\n",
         kernel, (int)blockIdx.x, (int)blockIdx.y, (int)threadIdx.x, what,
         index, lo, hi);
  __trap();
}

// lo <= index <= hi, or print and trap.
#define ECCKD_CHECK_RANGE(kernel, what, index, lo, hi)                      \
  do {                                                                      \
    const long long ecckd_i_ = (long long)(index);                          \
    const long long ecckd_lo_ = (long long)(lo);                            \
    const long long ecckd_hi_ = (long long)(hi);                            \
    if (ecckd_i_ < ecckd_lo_ || ecckd_i_ > ecckd_hi_)                       \
      ecckd_check_failed(kernel, what, ecckd_i_, ecckd_lo_, ecckd_hi_);     \
  } while (0)

#else

#define ECCKD_CHECK_RANGE(kernel, what, index, lo, hi) ((void)0)

#endif

// 0 <= index < limit.
#define ECCKD_CHECK_INDEX(kernel, what, index, limit) \
  ECCKD_CHECK_RANGE(kernel, what, index, 0, (long long)(limit) - 1)
