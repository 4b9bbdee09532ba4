// The ratquad family's K build and K backward kernels (stationary_k.cu has the design).
#define GPO_FAMILY 6
#include "stationary_k_kernels.cuh"
