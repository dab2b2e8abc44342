"""Command-line entry point: ``python -m paddle_tpu_torch <cmd>`` (the
port of ``paddle_tpu/cli.py``).

Config convention: ``--config`` names a python file that, when executed,
defines at module level:

- ``cost``       — the cost LayerOutput (required for train/dump)
- ``reader``     — a no-arg callable yielding sample tuples (train)
- ``test_reader`` — the same for ``--job=test`` (falls back to reader)
- ``optimizer``  — a paddle_tpu_torch.optimizer.Optimizer (default Adam)
- ``batch_size`` — int (default 32)

``train`` runs on ``cuda`` unless ``--device cpu``; ``--save_dir``
checkpoints every ``--saving_period`` passes and ``--start_pass``
resumes from one (``paddle_tpu_torch.checkpoint``), and ``--job=test``
evaluates a checkpoint from ``--save_dir`` or a tar from
``--init_model_tar``.  ``master`` serves the elastic-input master
(``paddle_tpu_torch.master``).  ``merge_model`` writes the config's
``outputs`` (else the cost's first input) with the weights of
``--model_dir``'s checkpoint or ``--model_tar`` as one merged inference
file (``paddle_tpu_torch.export.merge_model``), traced on ``cuda`` unless
``--device cpu``."""

from __future__ import annotations

import argparse
import runpy
import sys
from typing import Optional

def _load_config(path: str) -> dict:
    import paddle_tpu_torch as paddle

    paddle.topology.reset_name_scope()
    return runpy.run_path(path)


def _load_errors():
    """Exception classes meaning "the model artifact on disk is missing or
    corrupt" — a config mistake worth a one-line exit-2 message.
    Deliberately narrow: failures after a successful read keep their
    traceback."""
    import tarfile

    from paddle_tpu_torch.platform.enforce import EnforceError

    return (OSError, tarfile.ReadError, EnforceError, EOFError, KeyError,
            ValueError)


def cmd_train(args) -> int:
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch import trainer
    from paddle_tpu_torch.platform.device import resolve_device

    cfg = _load_config(args.config)
    cost = cfg["cost"]
    optimizer = cfg.get("optimizer") or opt_mod.Adam(learning_rate=1e-3)
    batch_size = int(cfg.get("batch_size", 32))
    # cheap config guards BEFORE parameter construction: a missing
    # reader must not pay a full init of a large model first
    if args.job == "train" and cfg.get("reader") is None:
        print("config must define reader() for train", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    paddle.init(device=dev)
    params = paddle.Parameters.from_topology(
        paddle.topology.Topology([cost]), device=dev)
    sgd = trainer.SGD(cost=cost, parameters=params,
                      update_equation=optimizer, device=dev)

    if args.job == "test":
        # evaluate a saved model on the config's test_reader
        reader = cfg.get("test_reader") or cfg.get("reader")
        if reader is None:
            print("config must define test_reader()/reader() for "
                  "--job=test", file=sys.stderr)
            return 2
        if args.init_model_tar:
            try:
                with open(args.init_model_tar, "rb") as f:
                    loaded = paddle.Parameters.from_tar(f, device=dev)
            except _load_errors() as e:   # a config mistake, not a crash
                print(f"cannot load model tar {args.init_model_tar}: {e}",
                      file=sys.stderr)
                return 2
            with torch.no_grad():
                for name, value in loaded.items():
                    if name in sgd.parameters:
                        sgd.parameters[name].copy_(value)
        elif args.save_dir:
            # the resume path: restores the optimizer and model state
            # too.  Only the disk read is guarded; apply_checkpoint
            # failures keep their traceback.
            from paddle_tpu_torch import checkpoint as ckpt

            try:
                loaded = ckpt.load_checkpoint(args.save_dir, device="cpu")
            except _load_errors() as e:
                print(f"cannot load checkpoint from {args.save_dir}: {e}",
                      file=sys.stderr)
                return 2
            sgd.apply_checkpoint(loaded)
        else:
            print("--job=test needs --save_dir or --init_model_tar",
                  file=sys.stderr)
            return 2
        result = sgd.test(paddle.batch(reader, batch_size))
        metrics = " ".join(f"{k}={v:.6g}" for k, v in
                           sorted(result.metrics.items()))
        print(f"Test cost={result.cost:.6g}" + (f" {metrics}" if metrics
                                                else ""))
        return 0

    sgd.train(paddle.batch(cfg["reader"], batch_size),
              num_passes=args.num_passes, save_dir=args.save_dir,
              start_pass=args.start_pass, saving_period=args.saving_period)
    if args.model_tar:
        with open(args.model_tar, "wb") as f:
            sgd.parameters.to_tar(f)
    return 0


def cmd_dump_config(args) -> int:
    from paddle_tpu_torch import utils
    from paddle_tpu_torch.topology import Topology

    cfg = _load_config(args.config)
    topo = Topology([cfg["cost"]])
    if args.format == "dot":
        print(utils.make_model_diagram(topo))
    else:
        print(utils.dump_config(topo))
    return 0


def cmd_merge_model(args) -> int:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch import export as pexport
    from paddle_tpu_torch.platform.device import resolve_device

    cfg = _load_config(args.config)
    outputs = cfg.get("outputs") or cfg["cost"].inputs[0]
    dev = resolve_device(args.device)
    try:
        if args.model_dir:
            params, _, _, _ = ckpt.load_checkpoint(args.model_dir,
                                                   device=dev)
        elif args.model_tar:
            with open(args.model_tar, "rb") as f:
                params = paddle.Parameters.from_tar(f, device=dev)
        else:
            print("need --model_dir or --model_tar", file=sys.stderr)
            return 2
    except _load_errors() as e:
        print(f"cannot load model from "
              f"{args.model_dir or args.model_tar}: {e}", file=sys.stderr)
        return 2
    pexport.merge_model(outputs, params, args.output, device=dev)
    print(f"wrote {args.output}")
    return 0


def cmd_master(args) -> int:
    import time

    from paddle_tpu_torch.master.server import MasterServer

    srv = MasterServer(host=args.host, port=args.port)
    srv.start()
    print(f"master serving on {srv.address}", flush=True)
    if args.dataset:
        srv.service.set_dataset(args.dataset)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_version(args) -> int:
    import torch

    import paddle_tpu_torch

    cuda = torch.version.cuda or "none"
    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"
    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__} "
          f"(torch {torch.__version__}, CUDA {cuda}, device {device})")
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch",
        description="PyTorch/CUDA trainer CLI (the `paddle` script analog)")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train or evaluate a config")
    t.add_argument("--config", required=True)
    t.add_argument("--job", choices=("train", "test"), default="train",
                   help="test = evaluate a saved model")
    t.add_argument("--num_passes", type=int, default=1)
    t.add_argument("--save_dir", default=None,
                   help="checkpoint directory (train: written every "
                        "--saving_period passes; --job=test: evaluated)")
    t.add_argument("--init_model_tar", default=None,
                   help="parameter tar to evaluate with --job=test")
    t.add_argument("--model_tar", default=None,
                   help="write the trained parameters to this tar")
    t.add_argument("--start_pass", type=int, default=0)
    t.add_argument("--saving_period", type=int, default=1)
    t.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    t.set_defaults(fn=cmd_train)

    d = sub.add_parser("dump_config", help="print the model config")
    d.add_argument("--config", required=True)
    d.add_argument("--format", choices=["json", "dot"], default="json")
    d.set_defaults(fn=cmd_dump_config)

    m = sub.add_parser("merge_model",
                       help="pack config+weights into one inference file")
    m.add_argument("--config", required=True)
    m.add_argument("--model_dir", default=None)
    m.add_argument("--model_tar", default=None)
    m.add_argument("--output", required=True)
    m.add_argument("--device", default=None,
                   help="cuda (the default) or cpu: where the program is "
                        "traced and runs")
    m.set_defaults(fn=cmd_merge_model)

    s = sub.add_parser("master", help="run the elastic-input master")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--dataset", nargs="*", default=None)
    s.set_defaults(fn=cmd_master)

    v = sub.add_parser("version")
    v.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:   # `... dump_config | head`
        return 0


if __name__ == "__main__":
    sys.exit(main())
