// quant_matmul_f16.cu — the fp16 cases of quant_matmul.cu (the
// tensor-core GEMV and dequant), a translation unit of their own so that
// nvcc builds them in parallel with the bf16 and fp32 cases (the build
// runs one nvcc a source, all started together).  strom_quant_gemv and
// strom_dequant hand fp16 calls to this unit's strom_quant_gemv_f16 and
// strom_dequant_f16.

#define STROM_QUANT_F16_TU
#include "quant_matmul.cu"
