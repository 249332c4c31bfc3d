// The 2D chunk kernel's many-material instances: plans of more than MAXMAT
// materials, whose constants are a device table and whose weights the
// mixers read from the const pack (manymat.cuh).  fused2d.cu compiled with
// DES_MANY, in a translation unit of its own, so that fused2d.cu's own
// instances compile as they did; its des_fused2d_chunk_f32 and
// des_fused2d_chunk_occupancy call the entries this file defines.
#define DES_MANY 1
#include "fused2d.cu"
