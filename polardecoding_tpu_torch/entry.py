"""Entry point: one Monte-Carlo super-batch of the BP_1024 pipeline (encode ->
BPSK/AWGN -> channel LLR -> 100-iteration BP decode -> error counters), the
port's counterpart of the JAX package's __graft_entry__.entry.

  python -m polardecoding_tpu_torch.entry          # runs the step on the card
"""
from __future__ import annotations


def entry(device="cuda"):
    """(step, example_args): the BP_1024 frame step at batch 256 and its
    arguments (key from the preset's seed, frame 0, 2.0 dB)."""
    from polardecoding_tpu_torch.configs import preset
    from polardecoding_tpu_torch.ops.channel import prng_key, sigma_from_ebn0_db
    from polardecoding_tpu_torch.parallel.harness import make_frame_step

    p = preset("BP_1024")
    step = make_frame_step(p, batch=256, device=device)
    return step, (prng_key(p.sweep.seed, device), 0, sigma_from_ebn0_db(2.0))


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [int(o) for o in fn(*args)])
