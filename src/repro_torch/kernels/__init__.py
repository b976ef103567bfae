"""Hand-written Hopper kernels with their wrappers and plain versions
(``flash_attention``, ``wkv6``, ``rglru_scan``, ``rmsnorm``, ``adamw``),
their shared build helper (``_build``), the layout wrappers (``ops``), the
torch oracles (``ref``) and the stdlib tile registry (``variants``)."""
