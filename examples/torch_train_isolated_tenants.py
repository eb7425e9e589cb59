"""End-to-end training on the PyTorch port: train a dense LM with the full
substrate — synthetic data pipeline, AdamW, checkpointing, restart — while
a tenant's checkpointed state is encrypted with the host key
(Space-Control's local-confidentiality model applied to framework state).

The demo runs a reduced qwen1.5 model for 40 steps, checkpointing at 20 and
40, restores the latest checkpoint into a fresh model and trains 10 more
steps; then the restored checkpoint's first leaf (the token table), viewed
as u32 words, goes through the memcrypt kernel and back.  The model runs on
the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/torch_train_isolated_tenants.py
    PYTHONPATH=src python examples/torch_train_isolated_tenants.py \\
        --device cpu

The full-size run is the launcher:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --preset full --steps 50 --batch 8 --seq 256
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.checkpointing import store
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import resolve_device
from repro_torch.kernels.ops import memory_decrypt, memory_encrypt
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import (init_model, make_batch, restore_state,
                                      train_state)

HOST_KEY = dict(key0=0x5EC2E7, key1=0x7E9A27)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(ARCHS["qwen1.5-0.5b"])
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                  global_batch=8))
    model, opt = init_model(cfg, dev)
    step_fn = build_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=100)

    ckpt_dir = tempfile.mkdtemp(prefix="tenant_ckpt_")
    try:
        losses = []
        for step in range(40):
            opt, m = step_fn(model, opt, make_batch(cfg, data, step, dev))
            losses.append(float(m["loss"]))
            if (step + 1) % 20 == 0:
                store.save(ckpt_dir, step + 1, train_state(model, opt))
                print(f"step {step+1:3d} loss {losses[-1]:.4f} "
                      "(checkpointed)")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise AssertionError("loss must decrease")
        print(f"loss {np.mean(losses[:5]):.3f} -> "
              f"{np.mean(losses[-5:]):.3f}")

        # --- simulate a node failure: restore and continue ----------------
        model2, opt2 = init_model(cfg, dev, seed=1)
        opt2, at = restore_state(ckpt_dir, model2, opt2)
        print(f"restored checkpoint at step {at}; continuing 10 more steps")
        for step in range(at, at + 10):
            opt2, m = step_fn(model2, opt2, make_batch(cfg, data, step, dev))
        print(f"post-restore loss {float(m['loss']):.4f}")

        # --- tenant-local confidentiality: checkpoints encrypted at rest --
        # (the paper's memory-encryption engine applied to the framework's
        #  own persistent state: an OS-level reader sees ciphertext)
        params, _ = train_state(model2, opt2)
        leaf = next(iter(params.values())).detach()
        words = leaf.reshape(-1).view(torch.int32)[:4096]
        enc = memory_encrypt(words, device=dev, **HOST_KEY)
        if torch.equal(enc, words):
            raise AssertionError("ciphertext equals the plaintext")
        dec = memory_decrypt(enc, device=dev, **HOST_KEY)
        if not torch.equal(dec, words):
            raise AssertionError("decryption did not return the leaf")
        print("checkpoint leaf encrypts/decrypts with the host key. OK")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("train_isolated_tenants OK")


if __name__ == "__main__":
    main()
