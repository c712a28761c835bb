"""The shape of every hand-written kernel launch in the traced solves.

The profiler's kernel events carry a name but, on this PyTorch, no launch
grid, so the block columns a launch covered are read where the launch is
made: around the kernel library's entry points (``ctypes`` functions of
``ops/kernels/block_kernels.py``'s library), for the traced solves only.
Each record is ``(label, bs, columns)``, the label as ``roofline.kernel_label``
reads the kernel's name; ``kernels_roofline`` pairs the records with the
kernel events in launch order and reads nothing where the two disagree.
"""

from __future__ import annotations


def _multisweep(cheb: bool):
    def shape(args):
        residual = args[11] is not None
        label = ("K5r" if residual else "K5") if cheb else ("K1" if residual else "K2")
        return label, int(args[0]), int(args[14]) - int(args[13])  # output columns [lo, hi)

    return shape


SHAPES = {  # entry point: its arguments -> (label, bs, block columns)
    "aggmg_multisweep": _multisweep(False),
    "aggmg_chebyshev": _multisweep(True),
    "aggmg_bt_matvec": lambda a: ("K3", int(a[0]), int(a[6])),
    "aggmg_ff_stencil_defect": lambda a: ("K6", int(a[0]), int(a[9])),
}


class Recorder:
    """``with Recorder() as rec:`` records ``rec.records`` while the
    library's entry points are wrapped; they are restored on exit."""

    def __init__(self):
        self.records = []
        self._saved = {}

    def __enter__(self):
        from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels

        self._lib = block_kernels._lib()
        for name, shape in SHAPES.items():
            orig = getattr(self._lib, name)
            self._saved[name] = orig

            def call(*args, _orig=orig, _shape=shape):
                self.records.append(_shape(args))
                return _orig(*args)

            setattr(self._lib, name, call)
        return self

    def __exit__(self, *exc):
        for name, orig in self._saved.items():
            setattr(self._lib, name, orig)
        return False
