"""The paper's comparison frameworks (Table 1 / Table 2 rows).

All baselines run on the byte-exact metered mock-HE/ring backends (the
same wire sizes a Paillier deployment serializes); EFMVFL itself also has
the real-Paillier path (mock ≡ Paillier).  Quality metrics, loss curves
and communication are therefore directly comparable.  Ring shares live
on `VFLConfig.device`; party float math stays numpy float64 on the host.
"""
from repro_torch.baselines import ss_glm, ss_he_lr, tp_glm

__all__ = ["tp_glm", "ss_glm", "ss_he_lr"]
