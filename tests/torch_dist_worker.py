"""One rank of the port's data-parallel tests on the CPU (run as a script
by ``test_torch_distributed.py``, once per rank, with torchrun's
environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
The ranks form a gloo group through ``iaf_torch``'s own entry points.
Imports no JAX: the JAX side of each comparison runs in the test
process, which hands this script its inputs (``inputs.pkl``: bridged
params, batches, injected noise) and reads back ``out_<rank>.pkl``.

Usage: python torch_dist_worker.py <directory>
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

WRITES: list[str] = []


def _record_writes() -> None:
    """Record every file this rank writes through the calls the entry
    points write with (atomic renames, numpy saves)."""
    def wrap(mod, name, dest):
        real = getattr(mod, name)

        def rec(*a, **kw):
            WRITES.append(str(getattr(a[dest], "name", a[dest])))
            return real(*a, **kw)
        setattr(mod, name, rec)

    wrap(os, "replace", 1)  # hps.json, eval progress files
    wrap(os, "rename", 1)   # checkpoints
    wrap(np, "save", 0)     # samples, recons, image tiles
    wrap(np, "savez", 0)    # checkpoint bodies


def _state_np(state) -> dict:
    return {"params": {k: v.detach().numpy().copy()
                       for k, v in state.params.state_dict().items()},
            "ema": {k: v.numpy().copy() for k, v in state.opt.ema.items()}}


def main() -> None:
    d = sys.argv[1]
    torch.set_num_threads(1)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    from iaf_torch import optim, train_lib
    from iaf_torch.core.config import Config
    from iaf_torch.models import cvae
    from iaf_torch.parallel import mesh
    from iaf_torch.parallel import train_step as ts
    from iaf_torch.parallel.eval_step import (make_batch_sharded_elbo,
                                              make_eval_step)

    out: dict = {}
    tcfg = Config().parse(inp["hp"])
    mesh.init_distributed(torch.device("cpu"))
    r, n = mesh.rank(), mesh.world()
    out["rank"], out["world"] = r, n
    _record_writes()

    def model_from(sd):
        m = cvae.CVAE(tcfg, device="cpu")
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return m

    # JAX's 2-device trajectory: the global noise injected, the local rows
    model = model_from(inp["params0"])
    state = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    step = ts.make_train_step(tcfg, state)
    per = tcfg.batch_size // n
    losses = []
    for i, (batch, noise) in enumerate(zip(inp["batches"], inp["noise"])):
        _, m = step(state, i, batch[r * per:(r + 1) * per],
                    noise={k: torch.from_numpy(v) for k, v in noise.items()})
        losses.append(float(m["loss"]))
    step.close()
    out["traj"] = _state_np(state)
    out["traj_losses"] = losses
    # the same steps through the eager step
    model = model_from(inp["params0"])
    state = ts.TrainState(model, optim.init_state(
        dict(model.named_parameters())))
    for i, (batch, noise) in enumerate(zip(inp["batches"], inp["noise"])):
        ts.train_step(tcfg, state, i, batch[r * per:(r + 1) * per],
                      noise={k: torch.from_numpy(v)
                             for k, v in noise.items()})
    out["traj_eager"] = _state_np(state)

    # the same at grad_accum=2: JAX's per-micro-batch global draws
    acfg = tcfg.replace(grad_accum=2)
    for name, graphed in (("traj_accum", True), ("traj_accum_eager", False)):
        model = model_from(inp["params0"])
        state = ts.TrainState(model, optim.init_state(
            dict(model.named_parameters())))
        step = ts.make_train_step(acfg, state) if graphed else None
        losses = []
        for i, (batch, noise) in enumerate(zip(inp["batches"],
                                               inp["noise_accum"])):
            noise = [{k: torch.from_numpy(v) for k, v in nz.items()}
                     for nz in noise]
            local = batch[r * per:(r + 1) * per]
            if graphed:
                _, m = step(state, i, local, noise=noise)
            else:
                _, m = ts.train_step(acfg, state, i, local, noise=noise)
            losses.append(float(m["loss"]))
        if graphed:
            step.close()
            out["traj_accum_losses"] = losses
        out[name] = _state_np(state)

    # the k-sharded IW eval, this rank's draws injected per chunk
    ecfg = tcfg.replace(eval_k_chunk=2)
    model = model_from(inp["params0"])
    noise = [{k: torch.from_numpy(v) for k, v in c.items()}
             for c in inp["eval_noise"][r]]
    out["eval_k8"] = make_eval_step(ecfg, "cpu", k=8)(
        model, 0, inp["eval_x"], noise=noise).numpy()
    # the batch-sharded k = 1 ELBO, the global draw injected
    out["eval_k1"] = make_batch_sharded_elbo(ecfg, "cpu", k=1)(
        model, 0, inp["eval_x"],
        noise={k: torch.from_numpy(v)
               for k, v in inp["k1_noise"].items()}).numpy()

    # world size does not change the step: train with no injected noise
    for fam in ("cifar", "mnist", "cifar_a2", "mnist_a2"):
        cfg = Config().parse(inp[f"inv_hp_{fam}"]).replace(
            logdir=os.path.join(d, f"inv_{fam}"))
        out[f"inv_{fam}"] = _state_np(train_lib.train(cfg, device="cpu"))

    # train, resume, evaluate: the sequence of distributed_worker.py
    cfg = Config().parse(inp["run_hp"]).replace(logdir=os.path.join(d, "run"))
    train_lib.train(cfg, device="cpu")
    train_lib.train(cfg, max_steps=8, device="cpu")
    out["bpd"] = train_lib.evaluate(cfg, k=8, max_batches=2, device="cpu")
    print(f"[rank {r}] bits_per_dim={out['bpd']!r}", flush=True)
    prog = os.path.join(d, "run", "eval_prog_test.json")
    out["full"] = train_lib.evaluate(cfg, k=8, max_batches=4, device="cpu")
    train_lib.evaluate(cfg, k=8, max_batches=2, progress_path=prog,
                       progress_every=1, progress_id="t", device="cpu")
    out["resumed"] = train_lib.evaluate(
        cfg, k=8, max_batches=4, progress_path=prog, progress_every=1,
        progress_id="t", device="cpu")
    out["bpd_k1"] = train_lib.evaluate(cfg, k=1, max_batches=2,
                                       device="cpu")
    train_lib.eval_loop(cfg, max_evals=1, k=8, max_batches=1,
                        poll_secs=0.01, device="cpu")
    out["samples"] = train_lib.sample(
        cfg, num=5, temperature=0.7, device="cpu",
        out_path=os.path.join(d, "run", "samples.npy"))
    out["heartbeat_k"] = train_lib.heartbeat_k(cfg)

    # what must raise
    raised = {}
    for name, bad in (("mesh_model", cfg.replace(mesh_model=2)),
                      ("mesh_data", cfg.replace(mesh_data=3))):
        try:
            mesh.check_config(bad)
        except (NotImplementedError, ValueError) as e:
            raised[name] = type(e).__name__
    try:   # 3 rows a rank: a global batch of 6 at grad_accum=2
        model = model_from(inp["params0"])
        ts.train_step(acfg, ts.TrainState(model, optim.init_state(
            dict(model.named_parameters()))), 0, inp["batches"][0][:3])
    except ValueError as e:
        raised["grad_accum"] = "ValueError"
        out["accum_error"] = str(e)
    out["raised"] = raised
    out["writes"] = WRITES
    mesh.barrier("done")
    with open(os.path.join(d, f"out_{r}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"TORCH_DIST_OK rank={r}", flush=True)


if __name__ == "__main__":
    main()
