// The narrow thin QR in double (the design is described in thin_qr.cuh).
// No path runs it: the QR gates send float64 to torch.linalg.
#include "thin_qr.cuh"

BENLSIP_THIN_QR_ENTRY(f64, double)
