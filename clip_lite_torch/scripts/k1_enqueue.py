"""The host's time to enqueue one call of K1's wrapper, checkouts in turns.

For each checkout root given, in order, a fresh process imports that
checkout's ``clip_lite_torch`` (and this checkout's ``chip_smoke.py``
for its timers), builds its K1 and times ``attention_forward`` at the
flagship text batch, qkv (128, 30, 2304) from
``chip_smoke.attention_inputs``: in bf16 at dropout 0.1 under the key
bias and under a full (128, 12, 30, 30) bias, as ``chip_smoke.py``'s K1
rows, and in fp32 under the key bias.  Each figure is
``chip_smoke.enqueue_ms`` (the mean host ms per call until it is
enqueued, 40 calls from an idle card), the least of five rounds.  Prints
the card's name and power limit, then one JSON line a run.  Give the
roots as A B B A to read each twice in turns; with another commit
unpacked into ``build/parent``:

    python clip_lite_torch/scripts/k1_enqueue.py . build/parent build/parent .
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
ROUNDS = 5


def one(root: Path) -> dict:
    """The enqueue times of the checkout at ``root``, in this process."""
    sys.path.insert(0, str(root))
    import torch

    import clip_lite_torch
    from clip_lite_torch.ops.attention import attention_forward

    if Path(clip_lite_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {clip_lite_torch.__file__}, not {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv32, key_bias, _ = chip_smoke.attention_inputs()
    b, s, nh = qkv32.shape[0], qkv32.shape[1], 12
    full_bias = key_bias[:, None, None, :].expand(b, nh, s, s).contiguous()
    cases = {"bf16_key_bias": (torch.bfloat16, key_bias, 0.1),
             "bf16_full_bias": (torch.bfloat16, full_bias, 0.1),
             "fp32_key_bias": (torch.float32, key_bias, 0.0)}
    row = {"root": str(root)}
    for name, (dtype, bias, rate) in cases.items():
        copies = chip_smoke.l2_spilling_copies(qkv32.to(dtype), bias)

        def fwd(x, m):
            return attention_forward(x, m, nh, dropout_rate=rate, seed=5)
        for x, m in copies[:3]:
            fwd(x, m)
        row[f"{name}_host_ms"] = min(chip_smoke.enqueue_ms(fwd, copies)
                                     for _ in range(ROUNDS))
        del copies
    return row


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k1_enqueue: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in argv or ["."]:
        run = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
