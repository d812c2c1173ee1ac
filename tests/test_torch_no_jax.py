"""The port imports no jax, flax, pandas or cv2 at module level (nor
scikit-learn or matplotlib, which the plots import when they draw).

Runs in a subprocess: the test process itself already holds jax.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import simple_tad_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in ("jax", "flax", "pandas", "cv2", "simple_tad_tpu",
                        "sklearn", "matplotlib")
             if m in sys.modules)
print(len(names), bad)
assert not bad, bad
# the int8 serving path's (its fused GEMMs too), the fine-tuning path's
# and InternVideo2's modules are among them
for name in ("ops.quant", "ops.int8_gemm", "ops.ln", "ops.flash_attention",
             "ops.attention", "models.layers", "models.internvideo2",
             "eval.engine", "cli.inference", "train.steps",
             "train.optim", "train.losses", "train.engine", "ops.augment",
             "utils.checkpoint", "utils.logging", "cli.finetune",
             # the pre-training path's and the trunk variants'
             "models.mae", "cli.pretrain", "data.masking",
             "data.pretrain_datasets", "utils.torch_convert",
             # the eval job's plots and grouped report, and distillation
             "eval.plots", "eval.analysis", "cli.data_tools",
             "models.iv2_distill", "train.distill", "cli.distill",
             # class fine-tuning, probing and the IV2 DAPT
             "data.video_cls_datasets", "cli.class_finetune",
             "cli.linear_probe",
             # data parallelism, the diagnostics, the eval CLI
             "parallel", "parallel.multihost", "parallel.mesh",
             "utils.diagnostics", "cli.eval_frames",
             # the rest of the JAX package's modules: the builders, the
             # native decoder, visualization, the efficiency harness and
             # the standalone reference
             "data.builders", "data.native", "cli.visualize",
             "cli.efficiency", "examples.standalone_inference"):
    assert "simple_tad_tpu_torch." + name in names, name
"""


def test_port_imports_no_jax_flax_pandas_cv2():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30, proc.stdout
