"""One bf16 ``cached`` parity step of tests/test_torch_train_step.py, dumped
op by op, to find what moves with the CPU's instruction set (ROADMAP queue
3, the AVX2 fault). Not a test: run it once per setting, then compare.

    JAX_PLATFORMS=cpu [ONEDNN_MAX_CPU_ISA=AVX2] python -m tests.isa_probe \\
        port OUT.npz [--no-mkldnn]
    JAX_PLATFORMS=cpu [ONEDNN_MAX_CPU_ISA=AVX2] python -m tests.isa_probe \\
        jax OUT.npz
    python -m tests.isa_probe compare A.npz B.npz

``port`` runs the port's step from the test's converted ``TrainState`` and
JAX's injected draws, with forward hooks on every module of the model and
the CKG (``--no-mkldnn``: under ``torch.backends.mkldnn.flags(enabled=
False)``), and keeps each module output, the losses and both optimizers'
momenta (the merge momentum carries the CKG's gradient). ``jax`` runs the
JAX step as the test compiles it and keeps the losses, the merge
parameters and momentum and the student's parameters. ``compare`` prints
every array that differs, with its max difference against its largest
entry.
"""

import collections
import contextlib
import dataclasses
import sys

import numpy as np

FLAVOR = "cached_bf16"


def _port(setup, no_mkldnn):
    import jax
    import torch

    import tests.test_torch_train_step as T
    from coin_tpu_torch.convert_from_jax import load_train_state
    from coin_tpu_torch.engine import step_builder as tsb
    from coin_tpu_torch.models.detector import OpenVocabularyRCNN
    from coin_tpu_torch.structures import Detections
    torch.set_num_threads(2)
    inp = setup.inputs
    j0, _ = T._jax_args(setup, FLAVOR)
    tokens = torch.from_numpy(np.asarray(setup.tokens)).long()
    model = OpenVocabularyRCNN(num_classes=T.C, text_layers=2, text_width=64,
                               text_heads=2, compute_dtype=torch.bfloat16)
    state = tsb.init_train_state(setup.cfg, model, tokens, seed=0)
    load_train_state(state, jax.device_get(dataclasses.replace(j0,
                                                                rng=None)))
    jpcfg = T._flavor_pcfg(setup.pcfg, FLAVOR)
    pcfg = T._port_cfg(jpcfg)
    step = tsb.build_adaptation_steps(
        tokens, pcfg, pcfg,
        tsb.StepHyper(**dataclasses.asdict(setup.hyper)))[1]
    td = lambda d: Detections(**{k: torch.from_numpy(v)
                                 for k, v in d.items()})
    out, calls = {}, collections.Counter()

    def hook(name):
        def record(module, args, result):
            results = result if isinstance(result, (tuple, list)) \
                else [result]
            for j, t in enumerate(results):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    calls[name] += 1
                    out[f"op{len(out):05d}|{name}|{calls[name]}|{j}"] = \
                        t.detach().float().numpy().copy()
        return record
    for root, m in (("model", state.model), ("merge", state.merge_model)):
        for n, mod in m.named_modules():
            mod.register_forward_hook(hook(f"{root}.{n}"))
    flags = (torch.backends.mkldnn.flags(enabled=False) if no_mkldnn
             else contextlib.nullcontext())
    with flags:
        state, losses = step(state, torch.from_numpy(inp["images"]),
                             torch.from_numpy(inp["hw"]),
                             td(inp["online_rcnn"]), td(inp["online_rpn"]),
                             td(inp["offline"]),
                             draws=T._draws(j0.rng, jpcfg, T.CAP_OFFLINE))
    out.update({f"loss|{k}": np.asarray(float(v)) for k, v in losses.items()})
    for prefix, opt in (("merge_momentum", state.merge_optimizer),
                        ("momentum", state.optimizer)):
        out.update({f"{prefix}|{k}": v.numpy()
                    for k, v in opt.momentum_buffers().items()})
    return out


def _jax(setup):
    import tests.test_torch_train_step as T
    j0, args = T._jax_args(setup, FLAVOR)
    step = setup.steps[FLAVOR].lower(j0, *args).compile(
        compiler_options=T.JAX_COMPILER_OPTIONS[FLAVOR])
    j1, losses = step(j0, *args)
    out = {f"loss|{k}": np.asarray(v) for k, v in losses.items()}
    out.update({f"merge_params|{k}": v
                for k, v in T._flat(j1.merge_params).items()})
    out.update({f"merge_momentum|{k}": v for k, v in
                T._flat(T._trace(j1.merge_opt_state)).items()})
    out.update({f"params|{k}": v for k, v in T._flat(j1.params).items()})
    return out


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    moved = 0
    for k in a.files:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        d = float(np.abs(x - y).max()) if x.size else 0.0
        if d > 0:
            moved += 1
            scale = max(float(np.abs(x).max()), 1e-30)
            print(f"{k}: max diff {d:.3g}, {d / scale:.3g} of its largest "
                  f"entry")
    print(f"{moved} of {len(a.files)} arrays differ")


def main(argv):
    if argv[0] == "compare":
        compare(argv[1], argv[2])
        return
    import tests.test_torch_train_step as T
    setup = T.setup.__wrapped__()
    out = (_port(setup, "--no-mkldnn" in argv) if argv[0] == "port"
           else _jax(setup))
    np.savez(argv[1], **out)


if __name__ == "__main__":
    main(sys.argv[1:])
