"""Typed configuration layer shared by all pipelines.

The reference configures every app through ad-hoc per-binary getopt loops
with inconsistent defaults (SURVEY.md §5: e.g. fec1 differs between
ofdmflexframe_tx and the ofdmtxrx library default; the ``-n`` flag collides
between apps).  This module is the single typed source of truth this
framework uses instead: dataclasses with validated fields, string parsing
for scheme names, and per-pipeline defaults recorded next to the reference
values they mirror.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..ops import crc as crc_mod
from ..ops import fec as fec_mod
from ..ops import modem as modem_mod

__all__ = ["OfdmConfig", "SingleCarrierConfig", "GmskConfig", "SyncConfig",
           "parse_crc"]


def parse_crc(name: str) -> int:
    table = {"none": crc_mod.CRC_NONE, "crc16": crc_mod.CRC_16,
             "crc32": crc_mod.CRC_32}
    try:
        return table[name.lower()]
    except KeyError:
        raise ValueError(f"unknown CRC scheme '{name}'; one of {list(table)}")


@dataclass
class SyncConfig:
    """Synchronizer sizing/budget shared by all frame families."""
    block_size: int = 16384
    max_payload: int = 2048
    max_frames: int = 8
    threshold: float = 0.5

    def validate(self):
        if self.block_size < 1024:
            raise ValueError("block_size too small")
        if not (0.0 < self.threshold < 1.0):
            raise ValueError("threshold must be in (0, 1)")
        return self


@dataclass
class FramePropsConfig:
    """Per-packet payload properties (string-typed; parsed to enums)."""
    check: str = "crc32"
    fec0: str = "none"
    fec1: str = "h128"
    mod: str = "qpsk"

    def to_props(self):
        from ..framing.ofdm import FrameProps
        return FrameProps(check=parse_crc(self.check),
                          fec0=fec_mod.fec_from_name(self.fec0),
                          fec1=fec_mod.fec_from_name(self.fec1),
                          mod=modem_mod.mod_from_name(self.mod))


@dataclass
class OfdmConfig:
    """OFDM pipeline (reference defaults: M=48/cp=6/taper=4 in the apps,
    /root/reference/src/ofdmflexframe_tx.cc:57-60)."""
    num_subcarriers: int = 48
    cp_len: int = 6
    taper_len: int = 4
    props: FramePropsConfig = field(default_factory=FramePropsConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)

    def validate(self):
        if self.num_subcarriers < 8:
            raise ValueError("number of subcarriers must be at least 8")
        if self.cp_len < 1:
            raise ValueError("cyclic prefix length must be at least 1")
        if self.taper_len > self.cp_len:
            raise ValueError("taper length cannot exceed cyclic prefix")
        self.sync.validate()
        return self


@dataclass
class SingleCarrierConfig:
    """flexframe pipeline (k=2 samples/symbol matched-filter chains)."""
    samples_per_symbol: int = 2
    filter_semilength: int = 7
    excess_bandwidth: float = 0.3
    props: FramePropsConfig = field(default_factory=FramePropsConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)

    def validate(self):
        if self.samples_per_symbol < 1:
            raise ValueError("samples_per_symbol must be >= 1")
        if self.filter_semilength < 1:
            raise ValueError("filter_semilength must be >= 1")
        if not (0.0 < self.excess_bandwidth < 1.0):
            raise ValueError("excess_bandwidth must be in (0, 1)")
        self.sync.validate()
        return self


@dataclass
class GmskConfig:
    """GMSK pipeline (k=2, BT=0.5; app defaults CRC16+h74,
    /root/reference/src/gmskframe_tx.cc:63-66)."""
    samples_per_symbol: int = 2
    bt: float = 0.5
    filter_semilength: int = 3
    props: FramePropsConfig = field(
        default_factory=lambda: FramePropsConfig(check="crc16", fec1="h74",
                                                 mod="bpsk"))
    sync: SyncConfig = field(default_factory=SyncConfig)

    def validate(self):
        if self.samples_per_symbol < 1:
            raise ValueError("samples_per_symbol must be >= 1")
        if not (0.0 < self.bt <= 1.0):
            raise ValueError("bt must be in (0, 1]")
        if self.filter_semilength < 1:
            raise ValueError("filter_semilength must be >= 1")
        self.sync.validate()
        return self
