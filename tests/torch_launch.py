"""Launch the port's ranks as torchrun would: one process per rank with
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK set (gloo on
the CPU in tests/test_torch_dist*.py; chip_smoke.py launches its ranks
on the card with it too). ``one_rank_group_check`` holds the train
step and the evaluation in a one-rank process group against the same
calls without one. Run as a script, this file is one rank that runs CLI
commands in turn in one gloo group (on the CPU, or on a card named by
``--device``), every rank at a barrier before each:

    python tests/torch_launch.py '[[OUT.npz or null, [<CLI argv>]], ...]'

A train command with an OUT writes what it ended with there: the
parameters as ``params/<name>`` arrays and a ``result`` JSON of the
run's counters (steps, losses, accuracies, plane, start epoch). A
denoise command with an OUT writes a ``result`` JSON of its final path
and of what ``run_hooks`` recorded. A run may carry a third element, a
dict of options for ``run_hooks``.
"""
import builtins
import contextlib
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list, world: int, timeout: float = 300,
           env: dict | None = None, cwd: str | None = None) -> list:
    """Run ``argv`` as ``world`` ranks on one node; [(returncode, stdout +
    stderr)] in rank order. ``argv`` may name ``{rank}``, filled per
    rank. Every process is gone when this returns."""
    port = str(free_port())
    base = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=port, WORLD_SIZE=str(world),
                OMP_NUM_THREADS="1", **(env or {}))
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [str(a).replace("{rank}", str(r)) for a in argv],
                cwd=cwd or REPO,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def cli(*args) -> list:
    """argv of one ``python -m deepsignal_plant_tpu_torch`` process."""
    return [sys.executable, "-m", "deepsignal_plant_tpu_torch", *args]


def rank_runs(runs: list) -> list:
    """argv of one rank of this script running ``runs`` ([OUT or None,
    CLI argv(, run_hooks options)] each) in turn."""
    return [sys.executable, os.path.abspath(__file__), json.dumps(runs)]


def train_rank(out: str, *flags) -> list:
    """argv of one rank of this script training once, its result to
    ``out``."""
    return rank_runs([[out, ["train", *flags]]])


def one_rank_group_check(device: str, backend: str, model_cfg, rows: int,
                         grad_tol: float, seed: int = 0) -> dict:
    """The port's train step and evaluation in a one-rank process group
    on ``backend`` (started by parallel.dist.start_group from the launch
    environment, which must be set) against the same calls made before
    the group starts, on ``rows`` random rows at ``model_cfg``'s widths
    and dropout 0: with a mask of ones the step's loss and parameters and
    the evaluation are the bytes of the step without a mask; with the
    last eighth of the rows replaced by row 0 and masked (as the sharded
    plane pads), the first step's update (SGD, so the update is the
    clipped gradient) is within ``grad_tol`` of max|update| of the step
    on the rows kept. The group is left running for the caller to use
    and end (parallel.dist.destroy). Returns the numbers compared."""
    import numpy as np
    import torch

    from deepsignal_plant_tpu_torch.io.dataset import FeatureDataset
    from deepsignal_plant_tpu_torch.models.bilstm import init_params
    from deepsignal_plant_tpu_torch.ops.optim import step_decay_schedule
    from deepsignal_plant_tpu_torch.parallel import dist
    from deepsignal_plant_tpu_torch.pipeline import train as T
    model_cfg = dataclasses.replace(model_cfg, dropout_rate=0.0)
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    L, S = model_cfg.seq_len, model_cfg.signal_len
    src = T.Resident(FeatureDataset(
        rng.integers(0, 4, (rows, L)).astype(np.int32),
        rng.normal(size=(rows, L)).astype(np.float32),
        np.abs(rng.normal(size=(rows, L))).astype(np.float32),
        rng.integers(1, 30, (rows, L)).astype(np.float32),
        rng.normal(size=(rows, L, S)).astype(np.float32),
        rng.integers(0, 2, rows).astype(np.int32)), dev)
    keep = rows - rows // 8
    pad = torch.cat([torch.arange(keep), torch.zeros(rows - keep,
                                                     dtype=torch.int64)])
    mask = (torch.arange(rows) < keep).float().to(dev)
    params = init_params(model_cfg, seed)

    def step(optim, idx, mask=None):
        rep = T.Replica(params, model_cfg, dev, optim,
                        step_decay_schedule(1e-2, 10, 2, 0.1), 1.5)
        before = [w.detach().clone() for w in rep.weights]
        loss = T.train_step([rep], [(*src.batch(idx.to(dev)), mask)], 0.5,
                            [None])
        return {"loss": loss.cpu(),
                "update": [(w.detach() - b).cpu()
                           for w, b in zip(rep.weights, before)],
                "eval": T.evaluate(rep.model, src, rows,
                                   rep.class_weights)}

    every = torch.arange(rows)
    alone = step("Adam", every)
    kept = step("SGD", torch.arange(keep))
    dist.start_group(backend)
    grouped = step("Adam", every, torch.ones(rows, device=dev))
    masked = step("SGD", pad, mask)
    same = (torch.equal(alone["loss"], grouped["loss"])
            and all(torch.equal(a, b) for a, b in zip(alone["update"],
                                                     grouped["update"]))
            and alone["eval"] == grouped["eval"])
    scale = max(u.abs().max().item() for u in kept["update"])
    err = max((a - b).abs().max().item()
              for a, b in zip(kept["update"], masked["update"]))
    assert same, ("the step in a one-rank group differs from the step "
                  f"without one: {alone['loss']} {grouped['loss']} "
                  f"{alone['eval']} {grouped['eval']}")
    assert err <= grad_tol * scale, (
        f"the masked step's update is {err} from the step on the rows "
        f"kept (max|update| {scale}, tolerance {grad_tol})")
    return {"rows": rows, "kept": keep, "loss": float(alone["loss"]),
            "masked_loss": float(masked["loss"]),
            "kept_loss": float(kept["loss"]),
            "masked_update_err": err, "update_scale": scale,
            "eval": grouped["eval"]}


#: the train counters a run's OUT keeps
RESULT_KEYS = ("steps", "start_epoch", "start_step", "epochs_run", "plane",
               "rank", "world_size", "local_batch", "step_losses",
               "valid_accuracies", "best_accuracy", "best_ckpt",
               "train_rows", "eval_tiles")


def half_digest(ds) -> str:
    """SHA-1 of a dataset's labels and signals: which rows a denoise
    mini-training trains on (either package's FeatureDataset)."""
    import numpy as np
    h = hashlib.sha1(np.asarray(ds.labels, np.int64).tobytes())
    h.update(np.asarray(ds.signals, np.float32).tobytes())
    return h.hexdigest()


def save_init_params(path: str, by_seed: dict) -> None:
    """Write initial parameters per seed ({seed: numpy pytree}) for the
    ``init_params`` option: arrays ``<seed>/<name>``."""
    import numpy as np

    from deepsignal_plant_tpu_torch.models.convert import _flatten
    np.savez(path, **{f"{seed}/{k}": v for seed, tree in by_seed.items()
                      for k, v in _flatten(tree).items()})


@contextlib.contextmanager
def run_hooks(opts: dict):
    """One run's options, undone when it ends; yields what they record.

    - ``env``: environment variables set for the run;
    - ``init_params``: a save_init_params file; denoise's mini-trainings
      start from its parameters for their seed (a missing seed raises);
    - ``watch``: a directory; every file this rank opens for writing or
      removes under it is recorded (``writes``);
    - ``host_fed_layout``: ``"global"`` gives train's host-fed plane the
      layout of one process over N devices (``GlobalBatch``: one
      permutation of every row an epoch, each rank its share of each
      global batch), which N local replicas take, in place of a launch's
      strided row shards (``ShardedHostFed``).

    Every denoise mini-training's seed, training rows and half_digest go
    to ``draws``."""
    import numpy as np

    from deepsignal_plant_tpu_torch.models.convert import _unflatten
    from deepsignal_plant_tpu_torch.pipeline import denoise as D
    from deepsignal_plant_tpu_torch.pipeline import train as T
    record = {"draws": [], "writes": []}
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    env = opts.get("env", {})
    env_before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    if "init_params" in opts:
        by_seed: dict = {}
        with np.load(opts["init_params"]) as z:
            for k in z.files:
                seed, name = k.split("/", 1)
                by_seed.setdefault(int(seed), {})[name] = z[k]
        patch(D, "init_params",
              lambda cfg, seed: _unflatten(by_seed[seed]))
    if opts.get("host_fed_layout") == "global":
        patch(T, "ShardedHostFed",
              lambda ds, device, rank, world, steps=None: T.GlobalBatch(
                  ds, device, rank, world, resident=False))
    real_tts = D.CrossRankTrainer.train_then_score

    def spy(self, train_ds, score_ds, seed, *a, **k):
        record["draws"].append([seed, len(train_ds), half_digest(train_ds)])
        return real_tts(self, train_ds, score_ds, seed, *a, **k)

    patch(D.CrossRankTrainer, "train_then_score", spy)
    watch = opts.get("watch")
    if watch:
        real_open, real_remove = builtins.open, os.remove

        def watched(path) -> bool:
            return (isinstance(path, (str, os.PathLike)) and os.path
                    .abspath(path).startswith(os.path.abspath(watch)))

        def open_(file, mode="r", *a, **k):
            if watched(file) and any(c in mode for c in "wax+"):
                record["writes"].append(["open", os.fspath(file)])
            return real_open(file, mode, *a, **k)

        def remove(path, *a, **k):
            if watched(path):
                record["writes"].append(["remove", os.fspath(path)])
            return real_remove(path, *a, **k)

        patch(builtins, "open", open_)
        patch(os, "remove", remove)
    try:
        yield record
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(runs: list) -> None:
    import numpy as np
    import torch.distributed as tdist

    from deepsignal_plant_tpu_torch import cli as port_cli
    from deepsignal_plant_tpu_torch.models.convert import _flatten
    from deepsignal_plant_tpu_torch.parallel import dist
    if not dist.init_distributed(backend="gloo"):
        sys.exit("no multi-process launch to join")
    try:
        for i, (out, argv, *opts) in enumerate(runs):
            tdist.barrier()
            print(f"[rank] run {i}", flush=True)
            args = port_cli.build_parser().parse_args(argv)
            with run_hooks(opts[0] if opts else {}) as record:
                res = args.func(args)
            if out is not None and argv[0] == "denoise":
                result = json.dumps({"final": res, "rank": tdist.get_rank(),
                                     **record})
                np.savez(out, result=np.frombuffer(result.encode(),
                                                   np.uint8))
            elif out is not None:
                result = json.dumps({k: res[k] for k in RESULT_KEYS})
                np.savez(out, result=np.frombuffer(result.encode(),
                                                   np.uint8),
                         **{"params/" + k: v
                            for k, v in _flatten(res["params"]).items()})
    finally:
        dist.destroy()


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(f"usage: {sys.argv[0]} '[[OUT or null, [CLI argv]], ...]'")
    _rank_main(json.loads(sys.argv[1]))
