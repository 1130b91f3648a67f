// K2 and K5 real on the plane-tile design (cheb_tile.cuh) with float32
// weight planes under float64 fields, widened on load; the recurrence
// runs in float64.  2-byte planes (bf16, f16) run cheb_smooth_narrow.cu's
// per-entry kernel (ops/stencil.py:cheb_design).  Entry point:
// cheb_smooth_tile (cheb_smooth_tile.cu).

#include "cheb_tile.cuh"

int cheb_smooth_tile_narrow(CHEB_TILE_ARGS) {
    return dispatch_real_tile<double, float>(CHEB_TILE_PASS);
}
