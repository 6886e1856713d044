"""serve — long-running call_mods over a watched directory (counterpart of
deepsignal_plant_tpu/pipeline/serve.py:37-245).

Sequencing runs deposit feature files continuously; this keeps ONE warm
engine (checkpoint loaded and packed for the kernels once, the kernels
and the native parser built once, CUDA brought up once) and calls each
file as it lands, instead of paying that start-up per CLI invocation.

Contract per input file ``X``:
    <result_dir>/X.call_mods.tsv      the calls (atomic: written to a
                                      dot-temp name, renamed when done;
                                      .gz kept in gzip mode)
    <result_dir>/X.done               marker: "<sites>\t<seconds>"
    <result_dir>/X.failed             marker: first line of the error

A file is picked up when its (size, mtime) is STABLE across two polls —
half-written uploads are never read — and is processed at most once
(markers are the dedup record, so restarts resume where they left off).
SIGTERM/SIGINT finish the in-flight file, then exit cleanly.

Producer-side completion markers: if ``X.complete`` exists next to input
``X``, ``X`` is picked up immediately (no stability wait).
``--require_complete`` makes the marker the only pickup signal.

The server calls features TSVs (``.tsv``, ``.tsv.gz``), .npz feature
batches (``.npz``: v1, v2 or v3 containers, as call_mods takes them) and
fast5 run-folders: a directory under the watched one that holds
``.fast5`` files anywhere below it, called through the fused fast5 path
(pipeline/extract.py::extract_to_call_mods) with the server's extraction
flags. A run-folder's stability signature is its file count, total
bytes and newest mtime.
"""
from __future__ import annotations

import os
import signal
import time

#: input file extensions the server calls (JAX serve.py:37)
_EXTS = (".tsv", ".npz", ".tsv.gz")


def _holds_fast5s(path: str) -> bool:
    for _root, _dirs, files in os.walk(path):
        if any(f.endswith(".fast5") for f in files):
            return True
    return False


def _stat_sig(path: str) -> tuple | None:
    """Stability signature: (size, mtime) for a file; (file count, total
    bytes, newest mtime) over the tree for a run-folder."""
    try:
        if not os.path.isdir(path):
            st = os.stat(path)
            return (st.st_size, st.st_mtime_ns)
        n = total = newest = 0
        for root, _dirs, files in os.walk(path):
            for f in files:
                try:
                    st = os.stat(os.path.join(root, f))
                except OSError:
                    continue
                n += 1
                total += st.st_size
                newest = max(newest, st.st_mtime_ns)
        return (n, total, newest)
    except OSError:
        return None


class WatchServer:
    """Poll-loop server around one warm CallModsEngine. ``served``, when
    a list, gets one ``(name, CallStats)`` per input called.
    ``extract_args`` (an argparse-like namespace with the extraction
    flags: motifs, corrected_group, nproc, ...) enables run-folders."""

    def __init__(self, engine, watch_dir: str, result_dir: str,
                 poll_s: float = 2.0, is_gzip: bool = False,
                 require_complete: bool = False,
                 served: list | None = None, extract_args=None):
        self.engine = engine
        self.extract_args = extract_args
        self.watch_dir = watch_dir
        self.result_dir = result_dir
        self.poll_s = poll_s
        self.is_gzip = is_gzip
        self.require_complete = require_complete
        self.served = served
        self._stop = False
        self._last_sig: dict[str, tuple] = {}
        os.makedirs(result_dir, exist_ok=True)

    def request_stop(self, *_):
        self._stop = True

    def _marker(self, name: str, kind: str) -> str:
        return os.path.join(self.result_dir, f"{name}.{kind}")

    def _is_done(self, name: str) -> bool:
        return (os.path.exists(self._marker(name, "done"))
                or os.path.exists(self._marker(name, "failed")))

    def _ready(self, path: str) -> bool:
        """Producer marker wins; else stable across two polls (size+mtime
        unchanged). With require_complete, the marker is the ONLY signal."""
        if os.path.exists(path + ".complete"):
            return True
        if self.require_complete:
            return False
        sig = _stat_sig(path)
        if sig is None:
            return False
        prev = self._last_sig.get(path)
        self._last_sig[path] = sig
        return prev == sig

    def process_one(self, path: str) -> bool:
        name = os.path.basename(path)
        out_name = name + ".call_mods.tsv" + (".gz" if self.is_gzip else "")
        final = os.path.join(self.result_dir, out_name)
        # the temp must END in .gz in gzip mode: the engine's AsyncWriter
        # forces the suffix (gzip_path), so any other temp name means the
        # writer writes <tmp>.gz and the rename below finds nothing
        tmp = os.path.join(self.result_dir, "." + name + ".tmp.call_mods.tsv"
                           + (".gz" if self.is_gzip else ""))
        t0 = time.time()
        try:
            if os.path.isdir(path):
                from .extract import extract_to_call_mods
                stats = extract_to_call_mods(self.engine, path,
                                             self.extract_args,
                                             result_file=tmp,
                                             is_gzip=self.is_gzip)
            else:
                stats = self.engine.run_features_file(
                    path, tmp, is_gzip=self.is_gzip)
            os.replace(tmp, final)
            with open(self._marker(name, "done"), "w") as fh:
                fh.write(f"{stats.sites}\t{time.time() - t0:.3f}\n")
            print(f"[serve] {name}: {stats.sites} sites in "
                  f"{time.time() - t0:.2f}s ({stats.sites_per_s:,.0f}/s)",
                  flush=True)
            if self.served is not None:
                self.served.append((name, stats))
            return True
        except Exception as exc:  # keep serving: one bad file != outage
            try:
                os.remove(tmp)
            except OSError:
                pass
            with open(self._marker(name, "failed"), "w") as fh:
                fh.write(str(exc).split("\n")[0] + "\n")
            print(f"[serve] {name}: FAILED ({exc})", flush=True)
            return False

    def _pending(self) -> list[str]:
        """Unprocessed candidates: files with a callable extension and
        run-folders, without a marker. The marker check runs before the
        run-folder probe, so a backlog of served run-folders costs two
        stats each per poll, not an os.walk each."""
        out = []
        for name in sorted(os.listdir(self.watch_dir)):
            if name.startswith("."):
                continue
            # never re-ingest our own products: with result_dir ==
            # watch_dir (nothing forbids it) the output X.call_mods.tsv
            # matches _EXTS and would be re-called forever
            if ".call_mods.tsv" in name or \
                    name.endswith((".done", ".failed", ".complete")):
                continue
            if self._is_done(name):
                continue
            path = os.path.join(self.watch_dir, name)
            if os.path.isfile(path):
                if name.endswith(_EXTS):
                    out.append(path)
            elif self.extract_args is not None and os.path.isdir(path) \
                    and _holds_fast5s(path):
                out.append(path)
        return out

    def sweep(self) -> int:
        """One poll: process every stable, unprocessed input. Returns the
        number of files processed."""
        n = 0
        pending = self._pending()
        # prune stability signatures of paths no longer pending (served,
        # failed, or deleted)
        live = set(pending)
        for stale in [p for p in self._last_sig if p not in live]:
            del self._last_sig[stale]
        for path in pending:
            if self._stop:
                break
            if not self._ready(path):
                continue
            self.process_one(path)
            n += 1
        return n

    def run(self, once: bool = False) -> None:
        if once:
            # process the current backlog: first poll records signatures,
            # second confirms stability. The polls must be poll_s apart —
            # back-to-back sweeps would compare signatures microseconds
            # apart and deem a mid-upload file "stable"
            self.sweep()
            time.sleep(self.poll_s)
            self.sweep()
            return
        while not self._stop:
            self.sweep()
            # interruptible sleep
            deadline = time.time() + self.poll_s
            while not self._stop and time.time() < deadline:
                time.sleep(0.1)
        print("[serve] stopped.", flush=True)


def serve(args) -> list:
    """CLI entry: build one warm engine and watch a directory. Returns
    ``(name, CallStats)`` of each input called."""
    import json

    import torch

    from ..config import CallConfig, model_config_from_args
    from ..ops import fused_lstm
    from ..parallel.dist import refuse_launch
    from ..utils.allocator import tune_host_allocator
    from ..utils.device import resolve_devices
    from .call_mods import CallModsEngine

    tune_host_allocator()
    refuse_launch("serve")
    # every visible card, as call_mods (serve refuses a launch)
    devices = resolve_devices(args.device)
    device = devices[0]
    model_cfg = model_config_from_args(args, device, args.dropout_rate)
    call_cfg = CallConfig(
        device_batch=args.device_batch or CallConfig.device_batch,
        transfer_dtype=("float16" if args.transfer_dtype == "auto"
                        else args.transfer_dtype),
        packed_wire=args.packed_wire,
        num_parse_workers=args.parse_workers)
    t0 = time.time()
    engine = CallModsEngine(os.path.abspath(args.model_path), model_cfg,
                            call_cfg, devices)
    startup = time.time() - t0
    served: list = []
    server = WatchServer(engine, os.path.abspath(args.watch_dir),
                         os.path.abspath(args.result_dir),
                         poll_s=args.poll_s, is_gzip=args.gzip,
                         require_complete=args.require_complete,
                         served=served, extract_args=args)
    # the caller's handlers come back when the server returns
    previous = {sig: signal.signal(sig, server.request_stop)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    print(f"[serve] watching {args.watch_dir} -> {args.result_dir} "
          f"(poll {args.poll_s}s, compute {model_cfg.compute_dtype}, "
          f"devices {', '.join(map(str, devices))}, once={args.once}); calls {', '.join(_EXTS)} "
          f"and fast5 run-folders", flush=True)
    try:
        server.run(once=args.once)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if args.verbose_stages:
        launches = dict.fromkeys(fused_lstm.kernel_launches(), 0)
        for _, st in served:
            for k, v in st.kernel_launches.items():
                launches[k] += v
        print("[stages] " + json.dumps({
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "devices": [str(d) for d in devices],
            "compute_dtype": model_cfg.compute_dtype,
            "engine_seconds": startup,
            "requests": [{"name": name, "sites": st.sites,
                          "seconds": st.seconds,
                          "sites_per_s": st.sites_per_s,
                          "forward_tiles": st.forward_tiles}
                         for name, st in served],
            "forward_tiles": sum(st.forward_tiles for _, st in served),
            "kernel_launches": launches}))
    return served
