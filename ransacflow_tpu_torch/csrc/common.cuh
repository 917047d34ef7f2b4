// Shared declarations of the kernel library.
//
// Every entry point is a plain C function: pointers and the stream come in
// as opaque handles from Python (ctypes), the kernel is launched on the
// caller's stream, nothing is allocated here, and the function returns
// cudaGetLastError() so that a refused launch is reported to the wrapper.
#pragma once

#include <cuda_runtime.h>

#define RF_API extern "C" __attribute__((visibility("default")))
