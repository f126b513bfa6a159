"""Device programs: hand-written CUDA kernels and their plain-torch twins.

Every kernel wrapper counts its launches in its ``launches`` attribute
(one per kernel launch, nothing on the CPU); K1 and K3 also count their
launches with intensity coefficients in ``coeff_launches``. The functions
below read and reset them all at once.
"""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name."""
    from . import (descriptors, dog, downsample, epilogue, fusion, intensity,
                   nonrigid, phasecorr, shard, solve)

    return {**fusion.KERNEL_WRAPPERS, **downsample.KERNEL_WRAPPERS,
            **phasecorr.KERNEL_WRAPPERS, **solve.KERNEL_WRAPPERS,
            **dog.KERNEL_WRAPPERS, **descriptors.KERNEL_WRAPPERS,
            **intensity.KERNEL_WRAPPERS, **nonrigid.KERNEL_WRAPPERS,
            **epilogue.KERNEL_WRAPPERS, **shard.KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "coeff_launches"):
            fn.coeff_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def coeff_launch_counts() -> dict:
    """K1's and K3's launches with intensity coefficients, as
    ``<name>+coeff``."""
    return {f"{name}+coeff": fn.coeff_launches
            for name, fn in kernel_wrappers().items()
            if hasattr(fn, "coeff_launches")}
