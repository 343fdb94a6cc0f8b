"""A later cell, configuration and per-layer metric are new files and
entries alone: in a copy of the benchmark with a configuration, a traffic
mix, a metric reader and a limits file added and BENCHMARK.json extended,
no harness file edited, the new cell runs (tiny, on the CPU) and reports
the new metric."""
import json
import shutil

from benchmark import harness
from benchmark.conftest import run_tiny, tiny_spec

READER = '''
def read(ctx):
    if ctx.unit != "step" or not ctx.trace.n_device_ops:
        return None
    return ctx.trace.group_s.get("moments", 0.0) * 1e3 / ctx.units
'''


def test_new_cell_config_and_metric_from_added_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root) : p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}

    cfg = json.loads((root / "benchmark/configs/stunet-b.json").read_text())
    cfg.update(name="stunet-l", model_size="L", stage_widths=[64, 128, 256, 512, 1024, 1024],
               blocks_per_stage=[2] * 6)
    cfg["pretrain"].update(decoder_width=1024)
    (root / "benchmark/configs/stunet-l.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/anatomask.json").read_text())
    traffic.update(batch=2, keep_ratio=0.5)
    (root / "benchmark/traffic/anatomask-hard.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/moments_ms.train.py").write_text(READER)
    (root / "benchmark/limits/pretrain-L.hard.json").write_text(
        (root / "benchmark/limits/pretrain-B.anatomask.json").read_text())
    manifest["configs"].append({"name": "stunet-l", "source": "https://arxiv.org/abs/2304.06716",
                                "file": "benchmark/configs/stunet-l.json", "reduced": [],
                                "why": "STU-Net-L"})
    manifest["workloads"].append({"name": "pretrain-L.hard", "config": "stunet-l",
                                  "traffic": "anatomask-hard", "chips": 1, "why": "harder masks"})
    manifest["per_layer"].append({"name": "moments_ms.train", "unit": "ms/step",
                                  "better": "lower", "source": "device_trace", "layer": "Kernels",
                                  "moves": "train_patches_per_s"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_patches_per_s":
            m["workloads"].append("pretrain-L.hard")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    # nothing that was there changed
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, rel
    spec = harness.load_spec("pretrain-L.hard", root)
    assert spec.config["stage_widths"][0] == 64 and spec.traffic["keep_ratio"] == 0.5
    assert "moments_ms.train" in [m["name"] for m in spec.per_layer()]
    assert "train_patches_per_s" in [m["name"] for m in spec.end_to_end()]
    # the new cell runs from that checkout, its new metric read from the trace
    tiny = tiny_spec("pretrain-L.hard", "float32", root)
    res = run_tiny(tiny, trace=True)
    assert "moments_ms.train" in res["metrics"] or not res["device"].get("busy_s")
    assert set(res["metrics"]) <= {m["name"] for m in spec.per_layer()}
    assert res["correct"]
    # and the harness reads it where a trace holds the kernel
    summary = __import__("benchmark.trace", fromlist=["TraceSummary"]).TraceSummary(
        window_s=1.0, busy_s=0.5, group_s={"moments": 0.004}, n_device_ops=3)
    ctx = harness.Context("pretrain-L.hard", "step", 2, summary, None, {}, None)
    reader = harness.load_module(root / "benchmark/metrics/moments_ms.train.py", "_m")
    assert reader.read(ctx) == 2.0
