"""The ranks of ``tests/test_torch_tp_serve.py``: the port serving on a
``(data, model)`` mesh, over gloo on the CPU.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  ``serve_rank`` runs every
part of the test file's job on a (data 2, model 2) mesh and returns what
its rank saw; every rank returns digests, so the test can hold the ranks
to each other, and rank 0 returns the arrays."""
import copy
import hashlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Env
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import init_shards
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, generate,
                               insert_request, make_slab)
from repro_torch.serve.slab import caches_to_numpy


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _counts() -> dict:
    """The collectives made since the last reset, with their bytes."""
    return dict(all_gather=collectives.counts["all_gather"],
                reduce=collectives.model_counts["reduce"],
                others=sum(collectives.counts.values()) - collectives.counts["all_gather"]
                + sum(collectives.model_counts.values()) - collectives.model_counts["reduce"],
                all_gather_bytes=collectives.nbytes["all_gather"],
                reduce_bytes=collectives.nbytes["reduce"])


def _prefill_decode(cfg, local, case) -> dict:
    """Prefill of ``case["prompts"]`` into caches of ``target_len``, then a
    decode step per column of ``case["feed"]``: every position's gathered
    logits, the last position's (``last_only``), each step's logits and
    the caches after the prefill and after the last step (this rank's
    heads), with the collectives of the first decode step."""
    tokens = torch.from_numpy(case["prompts"])
    logits, caches = prefill(cfg, local, tokens, target_len=case["target_len"])
    last, _ = prefill(cfg, local, tokens, target_len=case["target_len"], last_only=True)
    out = dict(prefill=logits.numpy(), last=last.numpy(),
               caches=copy.deepcopy(caches_to_numpy(caches)))  # the steps write in place
    steps = []
    for j in range(case["feed"].shape[1]):
        collectives.reset_counts()
        step, caches = decode_step(cfg, local, caches, torch.from_numpy(case["feed"][:, j:j + 1]))
        if j == 0:
            out["decode_counts"] = _counts()
        steps.append(step.numpy())
    out["decode"] = np.stack(steps)
    out["decoded_caches"] = caches_to_numpy(caches)
    return out


def _engine(cfg, local, mesh, run, dtype, temperature: float = 0.0) -> dict:
    """The engine on the mesh over ``run``'s requests and coded tier, one
    step at a time: per step the live requests' slots, the collectives,
    the slots it admitted into and whether it decoded; then every
    request's tokens and timestamps, the latencies and the slab's leaf
    shapes."""
    env = Env.from_dict(run["env"])
    eng = ServeEngine(cfg, local, ServeConfig(run["n_slots"], run["max_len"], dtype),
                      coded=CodedDecode.solve(env, budget=4, seed=0), device="cpu", mesh=mesh)
    reqs = [eng.submit(p, max_new=n, arrival=float(t), temperature=temperature,
                       seed=1000 + i)
            for i, (p, n, t) in enumerate(zip(run["prompts"], run["news"], run["times"]))]
    slots, steps = [], []
    while True:
        waiting = [r for r in reqs if r.t_admit is None]
        n_lat = len(eng.step_latencies)
        collectives.reset_counts()
        more = eng.step()
        steps.append(dict(_counts(), admitted=[r.slot for r in waiting if r.t_admit is not None],
                          decoded=len(eng.step_latencies) - n_lat))
        if not more:
            break
        slots.append([(i, r.slot) for i, r in enumerate(reqs) if r.slot is not None])
    return dict(slots=slots, steps=steps, latencies=list(eng.step_latencies), now=eng.now,
                rows=eng.rows.rows,
                slab=[{k: tuple(v.shape) for k, v in seg.items()} for seg in eng.slab],
                finished=[r.uid - reqs[0].uid for r in eng.finished],
                reqs=[dict(tokens=list(r.tokens), t_admit=r.t_admit, t_first=r.t_first,
                           t_done=r.t_done, n_steps=r.n_steps, state=r.state) for r in reqs])


def _teacher_forced(cfg, local, outputs, s: int, max_len: int, dtype) -> np.ndarray:
    """Decode logits (T, B, V) on a slab of every row (this rank's heads)
    fed each row's own tokens ``outputs`` (B, s + T + 1) after its prompt
    ``outputs[:, :s]``."""
    slab = make_slab(cfg, outputs.shape[0], max_len, dtype=dtype, device="cpu", tp=local.tp)
    for slot in range(outputs.shape[0]):
        _, pref = prefill(cfg, local, torch.from_numpy(outputs[slot:slot + 1, :s]),
                          target_len=max_len, last_only=True)
        insert_request(cfg, slab, pref, slot)
    steps = []
    for t in range(outputs.shape[1] - s - 1):
        logits, _ = decode_step(cfg, local, slab, torch.from_numpy(outputs[:, s + t, None]))
        steps.append(logits[:, -1].numpy())
    return np.stack(steps)


def serve_rank(rank, world, path):
    """The job saved at ``path``: per case (an arch's reduced config, some
    of its fields replaced), prefill and decode steps on its shards; for the engine's arch, the engine's runs (fp32 slab greedy,
    fp32 slab at a temperature, bf16 slab greedy), ``generate`` and the
    teacher-forced bf16 and fp32 slabs."""
    blob = torch.load(path, weights_only=False)
    mesh = make_local_mesh(**blob["mesh"], device="cpu")
    out = {"coords": (mesh.pod_index, mesh.data_index, mesh.model_index), "archs": {}}
    for name, case in blob["archs"].items():
        cfg = get_config(case["arch"]).reduced(**case["reduced"]).replace(**case["replace"])
        local = init_shards(cfg, mesh, device="cpu", params=case["tree"])
        got = _prefill_decode(cfg, local, case)
        got["axes"] = sorted(local.tp.axes)
        got["digest"] = digest([got["prefill"], got["last"], got["decode"]])
        out["archs"][name] = got
    run = blob["engine"]
    cfg = get_config(run["arch"]).reduced(**run["reduced"])
    local = init_shards(cfg, mesh, device="cpu", params=blob["archs"][run["arch"]]["tree"])
    out["greedy"] = _engine(cfg, local, mesh, run, torch.float32)
    out["sampled"] = _engine(cfg, local, mesh, run, torch.float32, temperature=0.8)
    out["bf16"] = _engine(cfg, local, mesh, run, torch.bfloat16)
    out["generate"] = generate(cfg, local, run["batch"], max_new=5, device="cpu",
                               mesh=mesh).numpy()
    outputs, s = run["forced"], run["forced_prompt"]
    out["forced_bf16"] = _teacher_forced(cfg, local, outputs, s, run["max_len"],
                                         torch.bfloat16)
    out["forced_fp32"] = _teacher_forced(cfg, local, outputs, s, run["max_len"],
                                         torch.float32)
    out["forced_prefill"] = prefill(cfg, local, torch.from_numpy(outputs))[0].numpy()
    return out
