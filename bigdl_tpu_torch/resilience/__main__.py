"""CLI: ``python -m bigdl_tpu_torch.resilience`` (counterpart of
``bigdl_tpu/resilience/__main__.py``).

Subcommands:

- ``chaos selftest``: exercise the injectors deterministically (no
  device);
- ``chaos drill [--replicas N] [--disaggregate P:D] [--requests R]
  [--device cuda|cpu]``: the kill-one-replica serving drill — a tiny
  in-process fleet behind ``LMRouter``, one decode replica killed
  mid-stream via ``kill-replica@K``; prints a JSON report, exit 0 iff no
  request was lost and every answer holds against ``generate``.

``validate``, ``latest`` and ``chaos corrupt`` read and damage checkpoint
snapshots; they wait for the checkpoint port (ROADMAP A.5) and exit with
a message naming it.
"""

from __future__ import annotations

import argparse
import sys

from bigdl_tpu_torch.resilience import chaos as chaos_mod


def _cmd_waits(args) -> int:
    raise SystemExit(f"{args.what} reads checkpoint snapshots, which are not "
                     "ported yet: ROADMAP A.5 (checkpoint and resume)")


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
    for name in ("validate", "latest"):
        p = sub.add_parser(name, help="waits for ROADMAP A.5")
        p.add_argument("checkpoint_dir")
        p.set_defaults(fn=_cmd_waits, what=name)

    p = sub.add_parser("chaos", help="fault injection")
    csub = p.add_subparsers(dest="chaos_cmd", required=True)
    c = csub.add_parser("corrupt", help="waits for ROADMAP A.5")
    c.add_argument("snapshot_dir")
    c.set_defaults(fn=_cmd_waits, what="chaos corrupt")
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
