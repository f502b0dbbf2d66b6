// The shapes the kernels' library instantiates (step_math.cuh::with_dims):
// (Dx, Dy, hidden width) of the presets, FitzHugh-Nagumo and Lorenz-63, each
// with one middle layer in K4/K15 and every plan in shared memory. The one
// list of them: with_dims expands PSVO_PREBUILT over these lines, and
// ops/fused_step.py reads them (PREBUILT_SHAPES); any other shape of the
// class is built into a shape library of its own (ops/_build.py).
PSVO_PREBUILT(2, 2, 16)
PSVO_PREBUILT(2, 2, 32)
PSVO_PREBUILT(2, 2, 64)
PSVO_PREBUILT(3, 3, 16)
PSVO_PREBUILT(3, 3, 32)
PSVO_PREBUILT(3, 3, 64)
