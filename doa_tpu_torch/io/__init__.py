"""Sample ingest and synthesis of the port (numpy on the host; the
pipelines move what they read to the card).

* ``synthetic``: the synthetic generators (a copy of doa_tpu.io.synthetic);
* ``recorded``: recorded-IQ files, ``.npz`` and raw ``.c64`` with a
  ``.json`` sidecar (a copy of doa_tpu.io.recorded; files cross-load);
* ``native``: the C++ framer (``csrc/framer.cpp``, built with g++) and the
  int8 ingest quantizer;
* ``stream``: the streaming driver (blocks → overlap carry → pipeline);
* ``socket_source``: UDP ingest, the wire format of doa_tpu's.
"""

from doa_tpu_torch.io.synthetic import synth_ula_iq, synth_ura_iq, SourceSpec
from doa_tpu_torch.io.recorded import save_iq, load_iq

__all__ = ["synth_ula_iq", "synth_ura_iq", "SourceSpec", "save_iq", "load_iq"]
