"""bigstitcher_spark_tpu_torch — the PyTorch/CUDA port of ``bigstitcher_spark_tpu``.

The same tools, on-disk contracts and outputs as the JAX package, on an
NVIDIA H100: plain tensor code is PyTorch, and every device program on a
ported path is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), with a plain-torch twin beside it in the same module. The twin
runs when the tensors live on the CPU; on the card the kernel runs or the
call raises.

Layout mirrors the JAX package (``io/``, ``utils/``, ``ops/``, ``models/``,
``cli/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (CLI: ``--device cpu``). Importing the package starts
nothing and compiles nothing: kernels are built at first launch.

Ported so far: ``create-fusion-container`` (with pyramids),
single-device ``affine-fusion`` (with the ``--pyramid`` epilogue and the
downsample stage), ``downsample``, single-device ``stitching``, the
``solver`` (stitching and interest-point sources; sharded over a solve
mesh above ``BST_SOLVE_SHARD`` rows), ``detect-interestpoints``,
``match-interestpoints``, ``match-intensities`` and ``solve-intensities``
(whose grids ``affine-fusion --intensityN5`` applies; its CG sharded the
same way), and single-device ``nonrigid-fusion``.
Everything else raises :class:`NotYetPorted`.
"""

__version__ = "0.1.0"


class NotYetPorted(NotImplementedError):
    """An option or code path the JAX package has and the port does not yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported (see ROADMAP.md)")
