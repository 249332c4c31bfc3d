// Kernel 3's many-material instances of phases A, C, E and G: plans of
// more than MAXMAT materials, whose constants are a device table and whose
// weights the mixtures read from the const pack (manymat.cuh).  fused3d.cu
// compiled with DES_MANY, in a translation unit of its own, so that
// fused3d.cu's own instances compile as they did; its des_fused3d_step_f32
// calls the entry this file defines.
#define DES_MANY 1
#include "fused3d.cu"
