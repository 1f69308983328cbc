"""CLI: ``python -m bigdl_tpu_torch.resilience`` (counterpart of
``bigdl_tpu/resilience/__main__.py``).

Subcommands:

- ``validate <checkpoint_dir>``: list every snapshot pair with its
  complete/PARTIAL verdict (plain files or sharded directories) and
  marker summary; exit 0 iff a resume point exists (no device is
  touched);
- ``latest <checkpoint_dir>``: print the newest complete (model, state)
  pair, one path per line;
- ``chaos corrupt <snapshot> [--shard N] [--mode flip|truncate|delete]
  [--seed S]``: deterministically damage a plain snapshot file, or one
  shard file of a sharded snapshot directory;
- ``chaos selftest``: exercise the injectors deterministically (no
  device);
- ``chaos drill [--replicas N] [--disaggregate P:D] [--requests R]
  [--device cuda|cpu]``: the kill-one-replica serving drill — a tiny
  in-process fleet behind ``LMRouter``, one decode replica killed
  mid-stream via ``kill-replica@K``; prints a JSON report, exit 0 iff no
  request was lost and every answer holds against ``generate``.
"""

from __future__ import annotations

import argparse
import sys

from bigdl_tpu_torch.resilience import chaos as chaos_mod
from bigdl_tpu_torch.resilience import coordinator


def _cmd_validate(args) -> int:
    import os
    pairs = coordinator.snapshot_pairs(args.checkpoint_dir)
    if not pairs:
        print(f"no snapshot pairs under {args.checkpoint_dir}")
        return 1
    any_ok = False
    for neval, _, model_name, state_name in reversed(pairs):
        model = os.path.join(args.checkpoint_dir, model_name)
        state = os.path.join(args.checkpoint_dir, state_name)
        ok = coordinator.validate_pair(model, state)
        any_ok = any_ok or ok
        marker = coordinator.read_marker(state) if ok else None
        tag = "complete" if ok else "PARTIAL "
        extra = ""
        if marker:
            mesh = marker.get("mesh") or {}
            extra = (f"  marker: step {marker.get('step')} epoch "
                     f"{marker.get('epoch')} procs "
                     f"{mesh.get('process_count')}")
        kind = " sharded" if os.path.isdir(model) else ""
        print(f"{tag}  {model_name} / {state_name}"
              f" (neval {neval}{kind}){extra}")
    return 0 if any_ok else 1


def _cmd_latest(args) -> int:
    point = coordinator.latest_resume_point(args.checkpoint_dir)
    if point is None:
        print("no complete snapshot", file=sys.stderr)
        return 1
    print(point.model_path)
    print(point.state_path)
    return 0


def _cmd_chaos_corrupt(args) -> int:
    info = chaos_mod.corrupt_snapshot(args.snapshot, mode=args.mode,
                                      seed=args.seed, shard=args.shard)
    print(f"corrupted {info['file']} ({info['mode']})")
    return 0


def _cmd_chaos_selftest(args) -> int:
    del args
    fired = []
    k = chaos_mod.KillAtStep(3, sig=0, _kill=lambda pid, sig: fired.append(3))
    for step in range(1, 6):
        k.on_step(step)
    assert fired == [3], fired
    slept = []
    d = chaos_mod.DelayAtStep(2, 0.25, _sleep=slept.append)
    for step in range(1, 6):
        d.on_step(step)
    assert slept == [0.25], slept
    specs = [chaos_mod.parse_spec(s) for s in
             ("kill@5", "kill@7:SIGINT", "delay@3:0.5")]
    assert [type(s).__name__ for s in specs] == ["KillAtStep", "KillAtStep",
                                                 "DelayAtStep"]

    # serving-plane injectors against stub server/router objects
    class _Stub:
        requests_admitted = 0
        decode_blocks = 0
    stub = _Stub()
    kr = chaos_mod.KillReplicaAfterRequests(2)
    kr.on_decode_block(stub)          # 0 admitted: no fire
    stub.requests_admitted = 2
    try:
        kr.on_decode_block(stub)
        raise AssertionError("KillReplicaAfterRequests did not fire")
    except chaos_mod.ChaosReplicaKill:
        pass
    kr.on_decode_block(stub)          # fires once only
    slept2 = []
    dd = chaos_mod.DelayDecodeStep(3, 0.125, _sleep=slept2.append)
    for block in range(1, 6):
        stub.decode_blocks = block
        dd.on_decode_block(stub)
    assert slept2 == [0.125], slept2
    dh = chaos_mod.DropHandoff(2)
    drops = [dh.on_handoff(None) for _ in range(4)]
    assert drops == [False, True, False, False], drops
    sspecs = [chaos_mod.parse_spec(s) for s in
              ("kill-replica@2", "delay-decode@3:0.25", "drop-handoff@1")]
    assert [type(s).__name__ for s in sspecs] == [
        "KillReplicaAfterRequests", "DelayDecodeStep", "DropHandoff"]
    print("chaos selftest: kill-at-step fired once at 3; delay slept 0.25s "
          "at 2; kill-replica raised once at 2 admissions; delay-decode "
          "slept 0.125s at block 3; drop-handoff dropped exactly the 2nd; "
          "spec parsing ok")
    return 0


def _cmd_chaos_drill(args) -> int:
    """Kill-one-replica fleet drill (``tests/test_torch_serving_fleet.py``
    pins it on the CPU)."""
    import json

    from bigdl_tpu_torch.resilience.serving_drill import run_kill_drill

    report = run_kill_drill(replicas=args.replicas,
                            disaggregate=args.disaggregate,
                            requests=args.requests,
                            kill_after=args.kill_after, device=args.device)
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.resilience",
        description="fault-injection tooling")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("validate", help="check every snapshot pair")
    p.add_argument("checkpoint_dir")
    p.set_defaults(fn=_cmd_validate)
    p = sub.add_parser("latest", help="newest complete snapshot pair")
    p.add_argument("checkpoint_dir")
    p.set_defaults(fn=_cmd_latest)

    p = sub.add_parser("chaos", help="fault injection")
    csub = p.add_subparsers(dest="chaos_cmd", required=True)
    c = csub.add_parser("corrupt", help="damage a snapshot file "
                        "deterministically")
    c.add_argument("snapshot", help="a model.N or state.N file, or a "
                   "sharded snapshot directory")
    c.add_argument("--shard", type=int, default=0,
                   help="which shard file of a sharded snapshot")
    c.add_argument("--mode", default="flip",
                   choices=["flip", "truncate", "delete"])
    c.add_argument("--seed", type=int, default=0)
    c.set_defaults(fn=_cmd_chaos_corrupt)
    c = csub.add_parser("selftest", help="deterministic injector check")
    c.set_defaults(fn=_cmd_chaos_selftest)
    c = csub.add_parser("drill",
                        help="kill-one-replica zero-loss serving drill")
    c.add_argument("--replicas", type=int, default=2)
    c.add_argument("--disaggregate", default=None, metavar="P:D",
                   help="prefill:decode split, e.g. 1:2")
    c.add_argument("--requests", type=int, default=6)
    c.add_argument("--kill-after", type=int, default=2,
                   help="kill replica 0 after it admits this many requests")
    c.add_argument("--device", default="cuda",
                   help="where the fleet runs (default cuda; cpu on request)")
    c.set_defaults(fn=_cmd_chaos_drill)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
