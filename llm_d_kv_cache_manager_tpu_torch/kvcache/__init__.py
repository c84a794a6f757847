"""Framework-free KV-cache control plane used by the serving pod: the
block-hash chain (``kvblock``) and the KV-event wire (``kvevents``)."""
