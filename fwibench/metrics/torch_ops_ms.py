"""Device milliseconds an epoch spends outside the hand-written kernels:
the generator's convolutions and products (cuDNN, cuBLAS), Adam, the
gradient processing and every other PyTorch operation and copy."""


def read(ctx):
    other = sum(b - a for n, a, b in ctx.in_window()
                if not ctx.hand_written(n))
    return 1e3 * other / ctx.epochs
