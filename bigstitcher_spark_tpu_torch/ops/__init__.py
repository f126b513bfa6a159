"""Device programs: hand-written CUDA kernels and their plain-torch twins.

Every kernel wrapper counts its launches in its ``launches`` attribute
(one per kernel launch, nothing on the CPU); the functions below read and
reset them all at once.
"""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name."""
    from . import descriptors, dog, downsample, fusion, phasecorr, solve

    return {**fusion.KERNEL_WRAPPERS, **downsample.KERNEL_WRAPPERS,
            **phasecorr.KERNEL_WRAPPERS, **solve.KERNEL_WRAPPERS,
            **dog.KERNEL_WRAPPERS, **descriptors.KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
