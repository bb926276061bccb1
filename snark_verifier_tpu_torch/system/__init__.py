"""Circuit systems and their host provers: StandardPlonk, LinearizedPlonk
and vanilla PLONK (`vanilla_plonk`, with its demo circuit in
`vanilla_fixtures`), and the halo2 vk digest (`vk_digest`)."""
