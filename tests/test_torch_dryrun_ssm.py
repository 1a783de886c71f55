"""The port's dry run of mamba2-1.3b's train step at full width and depth
on the 2 x 16 x 16 fake world under the baseline rules, in a process of
its own."""
import pytest

from test_torch_dryrun import rule_set_cell


@pytest.mark.parametrize("arch,shape,multi_pod,rules", [
    ("mamba2-1.3b", "train_4k", True, "baseline"),
])
def test_dryrun_cell_under_each_rule_set(arch, shape, multi_pod, rules):
    """The gated norm's mean over the head-sharded inner width, summed by
    hand, keeps "model" off the input projections' gradient's (B·S) dim:
    ``ok``."""
    rule_set_cell(arch, shape, multi_pod, rules)
