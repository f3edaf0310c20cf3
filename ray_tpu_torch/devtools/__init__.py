"""Developer tools of the port (counterpart of ray_tpu/devtools): the
CUDA host-sync tripwire (``syncdebug``) and the eager-torch lint rules
(``rules_torch`` over the ``lint`` core and ``dataflow``'s CFG)."""
