// The working type of a build and its explicitly rounded operations, shared
// by the history-attempt kernel (adams_attempt.cu, with pece_core.cuh), the
// split attempt's kernels (adams_split.cu) and div_small.cuh.
//
// A build is float64 (the default) or float32, chosen at compile time with
// -DSUNODE_REAL=double or -DSUNODE_REAL=float; the wrappers key a build on
// it (ops/adams_attempt.py, ops/adams_split.py).  Each helper is overloaded
// by type and rounds one operation on its own, as the plain PyTorch
// version computes it at that type: __dadd_rn ... at double, __fadd_rn ...
// at float.  Neither overload takes a mixed pair, so an operand of the other
// type (a double literal in float code) does not compile instead of
// silently promoting the operation.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef SUNODE_REAL
#define SUNODE_REAL double
#endif
typedef SUNODE_REAL real;

__device__ __forceinline__ double r_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float r_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double r_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float r_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double r_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float r_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double r_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float r_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double r_sqrt(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float r_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double r_abs(double a) { return fabs(a); }
__device__ __forceinline__ float r_abs(float a) { return fabsf(a); }
