"""Fault-tolerant training through the KSA control plane on the PyTorch
port (``examples/train_ft.py`` on ``repro_torch``).

A training run is a chain of idempotent step-chunk tasks (checkpoint →
n steps → checkpoint) distributed over agents; killing an agent mid-chunk
loses nothing: the monitor's watchdog resubmits and a surviving agent
resumes from the last checkpoint with bit-identical data. Unlike the
reference, the ``130m`` preset trains the full published width
(``TrainCampaign(smoke=False)``); ``smoke`` trains the reduced config.

Run:  PYTHONPATH=src python examples/torch_train_ft.py [--device cpu]
      PYTHONPATH=src python examples/torch_train_ft.py --preset 130m
"""
import argparse
import tempfile
import threading
import time

from repro_torch.cluster import KsaCluster
from repro_torch.convert import resolve_device
from repro_torch.core import ResourceProfile
from repro_torch.train import trainer  # registers "train_chunk"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "130m"], default="smoke")
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--kill-agent", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="where the chunks train (cuda or cpu)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # a CUDA campaign asks for one GPU a chunk: the workers must offer it
    profile = ResourceProfile(cpus=1, gpus=int(dev.type == "cuda"),
                              mem_mb=4096)

    with KsaCluster(prefix="tr", task_timeout_s=120.0, max_attempts=4,
                    session_timeout_s=1.0, default_partitions=2,
                    agent_kw=dict(heartbeat_interval_s=0.2)) as c, \
            tempfile.TemporaryDirectory(prefix="ksa_train_") as ckpt_dir:
        a1 = c.add_worker(slots=1, profile=profile)
        c.add_worker(slots=1, profile=profile)

        campaign = trainer.TrainCampaign(
            c.broker, c.submitter, c.monitor, arch=args.arch,
            ckpt_dir=ckpt_dir, total_steps=args.steps,
            chunk_steps=args.chunk, batch=4, seq=64, timeout_s=600.0,
            smoke=args.preset == "smoke", device=args.device, mem_mb=4096)
        if args.preset == "130m":
            # full mamba2-130m: fewer, bigger chunks
            campaign.chunk_steps = max(args.chunk // 2, 2)

        if args.kill_agent:
            def assassin():
                time.sleep(3.0)
                print("!! killing agent 1 mid-campaign")
                a1.crash()
            threading.Thread(target=assassin, daemon=True).start()

        t0 = time.time()
        out = campaign.run(wait_timeout=1800.0)
        dt = time.time() - t0
        print(f"\ntrained to step {out['final_step']} in {dt:.1f}s "
              f"across {out['chunks']} chunks; "
              f"final loss {out['final_loss']:.4f}")
        print("losses by chunk:", [round(r["loss"], 4)
                                   for r in campaign.chunk_results])
        print("monitor summary:", c.monitor.summary())
    print("OK")


if __name__ == "__main__":
    main()
