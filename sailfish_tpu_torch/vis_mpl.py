"""Matplotlib visualization engine (headless frame writer).

Port of ``sailfish_tpu/vis_mpl.py`` (the reference's
``sailfish/vis_mpl.py`` :15 and pygame 2D engine): renders the velocity
magnitude (plus every scalar field) of each output step to a PNG frame
with the Agg backend, so it runs without a display. A 3D field is drawn
as its mid-plane along z. matplotlib is imported when the engine is made,
so the rest of the port runs without it.
"""

from __future__ import annotations

import os

import numpy as np

from sailfish_tpu_torch.vis import FluidVis, register_engine


@register_engine
class MatplotlibVis(FluidVis):
    name = 'mpl'

    def __init__(self, config, fields_fn, out_dir=None):
        super().__init__(config, fields_fn)
        self.out_dir = out_dir or (getattr(config, 'output', '') or
                                   'vis') + '_frames'
        os.makedirs(self.out_dir, exist_ok=True)
        import matplotlib
        matplotlib.use('Agg')

    @staticmethod
    def _to2d(arr):
        if arr.ndim == 3:
            return arr[arr.shape[0] // 2]
        return arr

    def update(self, iteration):
        """Write ``frame_<iteration:07d>.png`` into ``out_dir``; returns
        its path."""
        import matplotlib.pyplot as plt
        fields = self.fields_fn()
        v = fields.pop('v', None)
        panels = {}
        if v is not None:
            panels['|v|'] = np.sqrt(sum(np.square(self._to2d(c)) for c in v))
        for name, arr in fields.items():
            panels[name] = self._to2d(np.asarray(arr))
        n = len(panels)
        fig, axes = plt.subplots(1, n, figsize=(5 * n, 4.2))
        if n == 1:
            axes = [axes]
        try:
            for ax, (name, arr) in zip(axes, panels.items()):
                im = ax.imshow(arr, origin='lower', cmap='viridis')
                ax.set_title(f'{name}  it={iteration}')
                fig.colorbar(im, ax=ax, shrink=0.8)
            fig.tight_layout()
            fname = os.path.join(self.out_dir, f'frame_{iteration:07d}.png')
            fig.savefig(fname, dpi=100)
        finally:
            plt.close(fig)
        return fname
