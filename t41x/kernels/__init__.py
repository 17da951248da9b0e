"""Hand-written device kernels: `agc_triton`, the AGC gain recurrence
as a Pallas kernel through Triton."""


def agc_kernel_for(platform: str) -> str | None:
    """The AGC kernel a chain uses on `platform` (a JAX backend name):
    the compiled Triton kernel on the GPU, the plain scan elsewhere.
    Interpret mode is never chosen here; tests ask for it by name."""
    return "triton" if platform == "gpu" else None
