"""liquid_usrp_tpu — a JAX software-radio framework.

A from-scratch JAX/XLA re-design of the capabilities of
jgaeddert/liquid-usrp (reference: /root/reference): OFDM / single-carrier /
GMSK packet modems, polyphase filterbank channelizers, resamplers, FEC/CRC,
modem constellations, NCO, AGC, spectrogram — all as pure functions over
batched IQ sample blocks with explicit carried state, jittable and shardable
over device meshes.

Design stance (vs. the reference's object-per-stream-operator, sample-at-a-
time, callback design — see SURVEY.md §7): every stream operator is
``step(state, block) -> (state', out)``; channels are a vmapped axis; devices
get ``(time_block, channel)`` mesh axes via ``shard_map``; halo/state exchange
uses ``ppermute``; callbacks become returned structured results.

Layering (mirrors the reference's L0-L3, SURVEY.md §1):
  - ``io``      — stream sources/sinks + channel impairments (replaces UHD, L0)
  - ``ops``     — DSP kernel library (replaces liquid-dsp, L1)
  - ``framing`` — framegen/framesync pairs (frame64/flexframe/gmsk/ofdmflex)
  - ``models``  — transceivers: ofdmtxrx, multichanneltx/rx/txrx (L2)
  - ``apps``    — CLI re-creations of the 16 reference binaries (L3)
  - ``parallel``— mesh / time-block / channel sharding + collectives
  - ``utils``   — config, timer, bit manipulation
"""

__version__ = "0.1.0"
