"""Probes that measure the card, the counterparts of the reference's
Pallas probes under `demos/`: `exp_interleave` (P2, two tape streams an
instance) and `exp_grid_overhead` (P3, the fixed cost of a launch and a
CTA). Each holds its kernel's wrapper, the plain PyTorch version beside
it and a `main()` that prints the reference's lines; run them as
`python -m fidget_tpu_torch.demos.<name>`."""
