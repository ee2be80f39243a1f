"""The port's config dataclasses against the JAX package's, field by
field (``tests/test_torch_*.py::test_config_mirrors_reference``)."""
import dataclasses

# fields only the port has, at the default that is the JAX package's
# behaviour: gates renormalised, plain RoPE, every prefill eager
PORT_ONLY = {"norm_topk_prob": True, "rope_scaling": None,
             "prefill_graph_bucket": 0}


def assert_config_mirrors(port, ref, label: str,
                          skip=("kernel_plan",)) -> None:
    """Every field both dataclasses have is equal, nested configs field by
    field; every port-only field is at its ``PORT_ONLY`` value."""
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        if f.name in skip:
            continue
        got, where = getattr(port, f.name), f"{label}.{f.name}"
        if f.name not in ref_fields:
            assert got == PORT_ONLY[f.name], where
            continue
        want = getattr(ref, f.name)
        if dataclasses.is_dataclass(got) and dataclasses.is_dataclass(want):
            assert_config_mirrors(got, want, where, skip=())
        else:
            assert got == want, where
