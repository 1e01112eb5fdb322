"""The sharded prover on a device mesh held by one process (counterpart of
``baby_plonk_tpu/parallel/``)."""
