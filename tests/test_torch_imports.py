"""The PyTorch port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, every module imports
with both blocked, and the engine's entry points run on the card unless
the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def test_every_module_imports_with_jax_and_reference_blocked():
    mods = [_module_name(p) for p in _port_files()]
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('imported', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
    assert len(mods) >= 21
    assert "repro_torch.kernels.flash_attention" in mods


@pytest.mark.parametrize("path", _port_files() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "repro")]
    assert not bad, f"{path}: imports {bad}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import PagedServingEngine
    _no_cuda(monkeypatch)
    cfg = reduced_config(get_config("qwen3-1.7b"))
    params = M.init_params(M.param_specs(cfg),
                           torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServingEngine(cfg, params)
    eng = PagedServingEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.cache["pos0"]["k"].device.type == "cpu"


def test_serve_paged_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch.serve import serve_paged
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_paged("qwen3-1.7b", requests=1)
    r = serve_paged("qwen3-1.7b", requests=3, gen=4, device="cpu")
    assert len(r["finished"]) == 3
    assert r["engine"].policy.decode_ticks > 0
    assert bool(r["engine"].policy.logits_finite)


def test_fixed_slot_engine_and_serve_default_to_cuda(monkeypatch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import ServingEngine
    _no_cuda(monkeypatch)
    cfg = reduced_config(get_config("qwen3-1.7b"))
    params = M.init_params(M.param_specs(cfg),
                           torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    eng = ServingEngine(cfg, params, slots=2, max_len=16, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.cache["pos0"]["k"].device.type == "cpu"
    assert eng.cache["pos0"]["k"].shape[2] == 17       # + scratch position
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("qwen3-1.7b", batch=1, gen=2)
    r = serve("qwen3-1.7b", batch=2, prompt_len=6, gen=3, device="cpu")
    assert r["generated"].shape == (2, 3)


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch, capsys):
    from repro_torch.launch.train import main, train
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train("qwen3-1.7b", steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--steps", "1", "--batch", "2", "--seq", "16"])
    losses = train("qwen3-1.7b", steps=2, batch=2, seq=16, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16"])
    assert "[train] done" in capsys.readouterr().out


def test_telemetry_is_accepted_and_leaves_the_flat_trace():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import PagedServingEngine
    from repro_torch.runtime.telemetry import Telemetry
    cfg = reduced_config(get_config("llama3-8b"))
    params = M.init_params(M.param_specs(cfg),
                           torch.Generator().manual_seed(0))
    out = {}
    for name, tel in (("off", None), ("on", Telemetry(ring=32))):
        eng = PagedServingEngine(cfg, params, device="cpu", telemetry=tel)
        assert eng.telemetry is tel
        for n in (5, 9):
            eng.submit(np.arange(n, dtype=np.int32), max_new_tokens=3)
        out[name] = ([q.generated for q in eng.run()], eng.trace)
    assert out["on"] == out["off"]
    assert tel.recorder.total == len(out["on"][1]) + 2      # + 2 submits


def test_registry_lists_ported_archs_only():
    from repro_torch.configs import ARCH_IDS, get_config, resolve_arch
    assert set(ARCH_IDS) == {"qwen3-1.7b", "llama3-8b"}
    assert resolve_arch("qwen3_1_7b") == "qwen3-1.7b"
    with pytest.raises(KeyError, match="known"):
        get_config("gemma3-12b")
    cfg = get_config("qwen3-1.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.head_dim) == \
        (28, 2048, 16, 8, 6144, 151_936, 128)
    assert cfg.qk_norm and cfg.tie_embeddings


def test_init_params_is_seeded_and_shaped():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    cfg = reduced_config(get_config("llama3-8b"))
    a = M.init_params(M.param_specs(cfg), torch.Generator().manual_seed(3))
    b = M.init_params(M.param_specs(cfg), torch.Generator().manual_seed(3))
    wq = a["blocks"]["pos0"]["mixer"]["wq"]
    assert wq.shape == (cfg.num_layers, cfg.d_model, cfg.num_heads,
                        cfg.head_dim)
    assert torch.equal(wq, b["blocks"]["pos0"]["mixer"]["wq"])
    assert "lm_head" in a and not a["final_norm"].any()
    std = float(a["embed"].std())
    np.testing.assert_allclose(std, 1 / np.sqrt(cfg.vocab_size), rtol=0.1)


def test_serve_cli_runs_on_cpu_and_rejects_bad_flags(capsys):
    from repro_torch.launch.serve import main
    main(["--engine", "paged", "--device", "cpu", "--requests", "2",
          "--gen", "3", "--kv-dtype", "int8", "--temperature", "0.7"])
    out = capsys.readouterr().out
    assert "device=cpu kv_dtype=int8" in out and "2 requests" in out
    with pytest.raises(SystemExit):
        main(["--engine", "paged", "--device", "cpu", "--class-precision",
              "premium=fp4"])
    with pytest.raises(SystemExit):
        main(["--engine", "paged", "--device", "cpu", "--prompt-len", "40",
              "--gen", "16", "--max-seq-len", "48"])


def test_serve_paged_draws_prompts_and_budgets_within_bounds():
    from repro_torch.launch.serve import serve_paged
    r = serve_paged("qwen3-1.7b", requests=4, gen=3, min_gen=3,
                    min_prompt_len=20, max_seq_len=26, device="cpu")
    assert len(r["finished"]) == 4
    for req in r["finished"]:
        assert 20 <= len(req.prompt) < 23
        assert req.max_new_tokens == 3 == len(req.generated)
    with pytest.raises(ValueError, match="min_gen"):
        serve_paged("qwen3-1.7b", gen=3, min_gen=4, device="cpu")
    with pytest.raises(ValueError, match="min_prompt_len"):
        serve_paged("qwen3-1.7b", gen=3, min_prompt_len=30,
                    max_seq_len=26, device="cpu")


def _reference_parser():
    """The JAX package's serve CLI parser, captured from its ``main()``
    at the point where it parses the command line."""
    import argparse
    from unittest import mock
    from repro.launch import serve as jserve

    class Captured(Exception):
        pass

    def capture(self, *a, **kw):
        raise Captured(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(Captured) as e:
            jserve.main()
    return e.value.args[0]


def _flags(ap):
    return {opt: act for act in ap._actions for opt in act.option_strings}


def test_serve_parser_matches_the_reference_but_for_device():
    """Every flag of the reference's serve CLI is the port's, with equal
    defaults and choices (the fleet flags with equal help too); the port
    adds only ``--device``."""
    from repro_torch.launch.serve import build_parser
    ref, port = _flags(_reference_parser()), _flags(build_parser())
    assert set(port) - set(ref) == {"--device"}
    assert set(ref) - set(port) == set()
    for opt, act in ref.items():
        assert (port[opt].dest, port[opt].default, port[opt].choices) == \
            (act.dest, act.default, act.choices), opt
    for opt in ("--fleet", "--models", "--selection", "--total-pages"):
        assert port[opt].help == ref[opt].help, opt
    assert port["--models"].default == "qwen3-1.7b:2,llama3-8b"
    assert port["--total-pages"].default == 64


def test_serve_fleet_defaults_to_cuda_and_finishes_on_cpu(monkeypatch,
                                                         capsys):
    from repro_torch.launch.serve import main, serve_fleet
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_fleet("qwen3-1.7b:2,llama3-8b")
    r = serve_fleet("qwen3-1.7b:2,llama3_8b:1:fp8", requests=7,
                    selection="slo-aware", device="cpu")
    assert sorted(r["finished"]) == list(range(7))
    for req in r["finished"].values():
        assert 2 <= len(req.generated) == req.max_new_tokens <= 8
    fleet = r["fleet"]
    assert [(n, i, e.kv_dtype) for n, i, e in fleet._engines()] == \
        [("qwen3-1.7b", 0, "bf16"), ("qwen3-1.7b", 1, "bf16"),
         ("llama3-8b", 0, "fp8")]
    q0, q1 = fleet.group("qwen3-1.7b").engines
    assert q0.params["embed"] is q1.params["embed"]     # one shared tree
    assert r["metrics"]["fleet"]["completed"] == 7
    with pytest.raises(ValueError, match="--models: unknown model"):
        serve_fleet("gpt5", device="cpu")
    main(["--fleet", "--device", "cpu", "--requests", "4",
          "--flight-recorder", "64", "--profile-ticks"])
    out = capsys.readouterr().out
    assert "[serve.fleet] device=cpu 4 requests" in out
    assert "model=qwen3-1.7b replicas=2" in out
    assert "model=llama3-8b replicas=1" in out
    assert "tick-phase profile" in out
