// The narrow thin QR in float32 (the design is described in thin_qr.cuh).
#include "thin_qr.cuh"

BENLSIP_THIN_QR_ENTRY(f32, float)
