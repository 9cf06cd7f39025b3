"""Sample visualization: self-contained HTML viewers of sampled structures
(counterpart of `jamun_tpu/metrics/visualize.py`, the same template). The
page embeds the PDB models inline and loads 3Dmol.js from its public CDN
when a browser opens it; writing it needs no network."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from jamun_tpu_torch.data.topology import save_pdb
from jamun_tpu_torch.metrics.base import TrajectoryMetric

__all__ = ["SampleVisualizer", "TrajectoryVisualizer"]

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head>
<script src="https://cdnjs.cloudflare.com/ajax/libs/3Dmol/2.0.4/3Dmol-min.js"></script>
<style>.viewer {{ width: 400px; height: 400px; position: relative; display: inline-block; }}</style>
</head><body>
<h2>{title}</h2>
{divs}
<script>
const models = {models};
models.forEach((pdb, i) => {{
  const v = $3Dmol.createViewer(document.getElementById("view" + i));
  v.addModelsAsFrames(pdb, "pdb");
  v.setStyle({{}}, {{stick: {{radius: 0.12}}, sphere: {{scale: 0.2}}}});
  v.zoomTo();
  if (pdb.includes("MODEL     2")) v.animate({{loop: "forward"}});
  v.render();
}});
</script>
</body></html>
"""


def _pdb_string(topology, frames: np.ndarray) -> str:
    import tempfile

    with tempfile.NamedTemporaryFile("r", suffix=".pdb", delete=False) as f:
        path = f.name
    save_pdb(path, topology, frames)
    with open(path) as f:
        s = f.read()
    os.remove(path)
    return s


class SampleVisualizer(TrajectoryMetric):
    """Writes an HTML grid of a few sampled structures, evenly spaced over
    the joined frames."""

    def __init__(self, dataset, output_dir: str = "sampler", max_samples: int = 6):
        super().__init__(dataset)
        self.output_dir = os.path.join(output_dir, dataset.label())
        self.max_samples = max_samples

    def compute(self) -> Dict[str, Any]:
        out = super().compute()
        pos = self.joined_positions
        if pos.shape[0] == 0:
            return out
        import json

        idx = np.linspace(0, pos.shape[0] - 1, min(self.max_samples, pos.shape[0])).astype(int)
        models = [_pdb_string(self.template.topology, pos[i : i + 1]) for i in idx]
        divs = "".join(f'<div class="viewer" id="view{i}"></div>' for i in range(len(models)))
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "samples.html")
        with open(path, "w") as f:
            f.write(
                _HTML_TEMPLATE.format(
                    title=f"Samples: {self.dataset.label()}", divs=divs, models=json.dumps(models)
                )
            )
        out["samples_html"] = path
        return out


class TrajectoryVisualizer(TrajectoryMetric):
    """Writes an HTML animation of one sampled chain."""

    def __init__(self, dataset, output_dir: str = "sampler", max_frames: int = 100):
        super().__init__(dataset)
        self.output_dir = os.path.join(output_dir, dataset.label())
        self.max_frames = max_frames

    def compute(self) -> Dict[str, Any]:
        out = super().compute()
        if not self.chains:
            return out
        import json

        traj = np.transpose(self.chains[0], (1, 0, 2))  # [frames, atoms, 3]
        stride = max(len(traj) // self.max_frames, 1)
        model = _pdb_string(self.template.topology, traj[::stride])
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "trajectory_animation.html")
        with open(path, "w") as f:
            f.write(
                _HTML_TEMPLATE.format(
                    title=f"Trajectory: {self.dataset.label()}",
                    divs='<div class="viewer" id="view0"></div>',
                    models=json.dumps([model]),
                )
            )
        out["animation_html"] = path
        return out
