// The rbf family's K build and K backward kernels (stationary_k.cu has the design).
#define GPO_FAMILY 0
#include "stationary_k_kernels.cuh"
