// The float64 instances of K1 and K2: chol_solve.cu's kernels and entry
// point for double, in a library of their own so that they build in
// parallel with the float32 one.  See chol_solve.cu.
#define OMG_CHOL_F64
#include "chol_solve.cu"
