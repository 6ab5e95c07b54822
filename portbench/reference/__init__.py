"""The benchmark's plain reference: the frame pipeline of the C reference
programs (CHEBSB/PolarDecoding) in plain PyTorch, frozen here so that the
yardstick does not move with the program it measures.

It imports nothing of the measured package and takes nothing it made: the
frozen set, the payloads, the CRC and the codewords are worked out again
from the configuration, and the noise from (seed, SNR, frame index) with
the same counter-based generator (threefry2x32, as jax.random draws it).
`step.frame_counters` gives the counters of one frame step; the decoders
run in any float dtype, which the control uses (bfloat16).
"""
