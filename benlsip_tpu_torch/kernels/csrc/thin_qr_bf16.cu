// The narrow thin QR in bf16: loads bf16, computes in float, rounds each
// output once (the design is described in thin_qr.cuh).
#include "thin_qr.cuh"

BENLSIP_THIN_QR_ENTRY(bf16, __nv_bfloat16)
