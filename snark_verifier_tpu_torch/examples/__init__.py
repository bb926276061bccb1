"""The port's examples, one per example of the JAX package (the repository's
examples/): each has `main(argv=None)`, runs on the CUDA card unless given
`--cpu`, and prints PASS only after its own checks.  Run one as

    python -m snark_verifier_tpu_torch.examples.verify_standard_plonk [--cpu]

or through the CLI (`python -m snark_verifier_tpu_torch --help`)."""
