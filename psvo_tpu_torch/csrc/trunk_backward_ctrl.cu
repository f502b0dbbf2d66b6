// K10 trunk_backward in its control mode (trunk_backward.cuh), a
// translation unit of its own so that the uncontrolled kernels build as
// before, and beside them, in parallel.
#include "trunk_backward.cuh"

namespace psvo {
template int dispatch_trunk_backward<true>(const TrunkBwdArgs&, int, int, int, int, int, int,
                                           float*, float*, cudaStream_t);
}  // namespace psvo
