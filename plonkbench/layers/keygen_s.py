"""keygen_s: the harness's clock around ``Program.from_strs`` and
``common_preprocessed_input`` in set-up: the circuit compiled and the
proving key's selector and permutation columns built (host Python)."""


def read(run):
    return run.setup_parts.get("keygen_s")
