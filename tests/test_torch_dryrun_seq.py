"""The port's dry run under sequence parallelism (the "opt" and "serve"
rule sets: act_seq over "model"), gemma-2b at full width and depth on the
16 x 16 fake world, each cell in a process of its own."""
import pytest

from test_torch_dryrun import rule_set_cell


@pytest.mark.parametrize("arch,shape,multi_pod,rules", [
    ("gemma-2b", "train_4k", False, "opt"),
    ("gemma-2b", "prefill_32k", False, "serve"),
])
def test_dryrun_cell_under_each_rule_set(arch, shape, multi_pod, rules):
    """The all-gather of the sequence before each column-parallel product
    (and, in the train step, its reduce-scatter backward): ``ok``."""
    rule_set_cell(arch, shape, multi_pod, rules)
