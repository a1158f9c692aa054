// K2 with an additive score bias (ALiBi's, the Bloom step's): the kernels
// of decode_attention.cu instantiated with BIAS, in a library of their own
// so that the two build side by side (ops/kernels/decode_attention.py
// loads this one for a call with a bias). _build counts the included
// source in this library's digest.
#define DECODE_ATTENTION_BIAS
#include "decode_attention.cu"
