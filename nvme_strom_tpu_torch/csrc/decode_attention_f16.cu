// decode_attention_f16.cu — the fp16 cases of decode_attention.cu, a
// translation unit of their own so that nvcc builds them in parallel with
// the bf16 and fp32 cases (the build runs one nvcc a source, all started
// together).  strom_decode_attention hands fp16 calls to this unit's
// strom_decode_attention_f16.

#define STROM_ATTN_F16_TU
#include "decode_attention.cu"
