// K9 trunk_forward in its control mode (trunk_forward.cuh), a translation
// unit of its own so that the uncontrolled kernels build as before, and
// beside them, in parallel.
#include "trunk_forward.cuh"

namespace psvo {
template int dispatch_trunk_forward<true>(const TrunkArgs&, int, int, int, int, int, int,
                                          int, cudaStream_t);
}  // namespace psvo
