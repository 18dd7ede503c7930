"""The port's copy of the paper's stencil cases lists what the JAX
package's does: names, specs, sizes, Table 3's options and blocks."""
import numpy as np

from repro.configs import paper_stencil as ref_cases

from repro_torch.configs import paper_stencil


def test_paper_cases_match_the_reference():
    ref = ref_cases.PAPER_CASES()
    port = paper_stencil.PAPER_CASES()
    assert [c.name for c in port] == [c.name for c in ref]
    assert len(port) == 11
    for a, b in zip(port, ref):
        assert (a.sizes, a.best_option, a.block) == \
            (b.sizes, b.best_option, b.block), a.name
        assert (a.spec.ndim, a.spec.order, a.spec.shape) == \
            (b.spec.ndim, b.spec.order, b.spec.shape), a.name
        np.testing.assert_array_equal(np.asarray(a.spec.gather_coeffs),
                                      np.asarray(b.spec.gather_coeffs))


def test_paper_cases_options_are_legal_covers():
    from repro_torch.core.engine import legal_covers
    for case in paper_stencil.PAPER_CASES():
        assert case.best_option in legal_covers(case.spec), case.name
        assert len(case.block) == case.spec.ndim
