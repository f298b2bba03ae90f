"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``,
the calibration script or the partitioning example) imports JAX or anything
of the reference package ``repro``."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "scripts" / "calibrate_costmodel_torch.py",
        ROOT / "examples" / "partition_transformer_torch.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not offenders, offenders


def test_imports_and_runs_without_jax():
    """Every module imports (the mesh, sharding and dry-run modules without
    initialising a process group), a tiny forward of each ported family
    (MoE with MLA and with GQA among them) runs, and
    MobileNetV2 is verified and served through the port's
    ``DistributedInference``, with JAX unimportable."""
    code = textwrap.dedent("""
        import importlib, pathlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        port = pathlib.Path(sys.argv[1])
        names = [".".join(("repro_torch",) + f.relative_to(port).with_suffix("").parts)
                 .removesuffix(".__init__") for f in sorted(port.rglob("*.py"))]
        for name in names:
            importlib.import_module(name)
        # the mesh, sharding and dry-run modules touch no process group (and
        # no CUDA device) when imported
        import torch.distributed as dist
        assert {"repro_torch.launch.mesh", "repro_torch.utils.sharding",
                "repro_torch.models.smblock", "repro_torch.launch.dryrun",
                "repro_torch.launch.roofline", "repro_torch.utils.hlo"} <= set(names)
        assert not dist.is_initialized() and not torch.cuda.is_initialized()
        from repro_torch.configs import get_config
        from repro_torch.models.model import Model
        for arch in ("qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v2-236b",
                     "kimi-k2-1t-a32b"):
            cfg = get_config(arch).reduced()
            model = Model(cfg)
            params, _ = model.init(torch.Generator().manual_seed(0), device="cpu")
            logits, _, _ = model.forward(params,
                                         {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
            assert logits.shape == (1, 4, cfg.padded_vocab) and torch.isfinite(logits).all()
        from repro_torch.core import DistributedInference, ModelPartitioner, make_paper_cluster
        from repro_torch.models.graph import mobilenetv2_graph
        from repro_torch.models.mobilenetv2 import build_mobilenetv2, run_range
        leaves = build_mobilenetv2(device="cpu")
        amp = DistributedInference(make_paper_cluster(), ModelPartitioner(mobilenetv2_graph()),
                                   executor=lambda lo, hi, x, res: run_range(leaves, lo, hi, x, res))
        assert amp.verify_numerics(torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(0)))
        assert amp.run(10).throughput_rps > 0
        assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
                       if sys.modules[m] is not None)
        print(len(names))
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code, str(PORT)], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
