"""The accelerator roofline and price table that the training
telemetry's MFU and the serving cost meter read (the port's own copy of
the part of the JAX package's ``generations.py`` they use). Stdlib only.

The TPU rows are the JAX package's, so a torch replica or trainer that
reports a TPU accelerator type computes what a JAX one does. The ``h100``
row is the published specification of the SXM H100 (NVIDIA's data sheet:
989 TFLOP/s dense bf16, 3.35 TB/s of HBM), the same figures the kernel
table's bounds use, not a measurement, and a list price from the same
cloud whose TPU prices the table copies (see the row).
``generation_of`` maps a card's ``torch.cuda.get_device_name()`` to
``h100`` only for the SXM card ("NVIDIA H100 80GB HBM3"): the PCIe and
NVL cards publish lower peaks and, like empty or unknown names, map to
``cpu``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """One accelerator generation's public roofline and on-demand list
    price."""

    name: str
    peak_tflops_bf16: float   # per chip or card, public spec sheets
    peak_hbm_gbps: float      # per chip or card HBM bandwidth, GB/s
    cost_per_chip_hr: float   # USD, on-demand list price (0: not priced)


GENERATIONS = {
    "v4": GenerationSpec("v4", peak_tflops_bf16=275.0,
                         peak_hbm_gbps=1228.0, cost_per_chip_hr=3.22),
    "v5e": GenerationSpec("v5e", peak_tflops_bf16=197.0,
                          peak_hbm_gbps=819.0, cost_per_chip_hr=1.20),
    "v5p": GenerationSpec("v5p", peak_tflops_bf16=459.0,
                          peak_hbm_gbps=2765.0, cost_per_chip_hr=4.20),
    "v6e": GenerationSpec("v6e", peak_tflops_bf16=918.0,
                          peak_hbm_gbps=1640.0, cost_per_chip_hr=2.70),
    # the published SXM H100 specification, not a measurement. Price:
    # Google Cloud's on-demand list price of the A3 High machine
    # (a3-highgpu-8g, 8 SXM H100s) in us-central1 (Iowa), $88.49 an hour,
    # over its 8 cards; source: Compute Engine's "VM instance pricing"
    # page, accelerator-optimized machine types, A3 High
    # (https://cloud.google.com/compute/vm-instance-pricing), as listed
    # in 2024. UNVERIFIED: the figure is recalled, not copied from the
    # page; re-read it there before quoting a dollar figure.
    "h100": GenerationSpec("h100", peak_tflops_bf16=989.0,
                           peak_hbm_gbps=3350.0,
                           cost_per_chip_hr=round(88.49 / 8, 4)),
    "cpu": GenerationSpec("cpu", peak_tflops_bf16=0.1,
                          peak_hbm_gbps=10.0, cost_per_chip_hr=0.01),
}

PEAK_TFLOPS_BF16 = {name: spec.peak_tflops_bf16
                    for name, spec in GENERATIONS.items()}

_GENERATION_PREFIXES = (
    ("v5litepod", "v5e"),
    ("v5p", "v5p"),
    ("v6e", "v6e"),
    ("v4", "v4"),
)


# the SXM H100's card names, as torch.cuda.get_device_name() gives them;
# the PCIe and NVL cards have lower published peaks and no row here
_H100_SXM_NAMES = ("h100 80gb hbm3", "h100 sxm")


def generation_of(accelerator_type: str) -> str:
    """Accelerator-type or card name -> generation key of GENERATIONS
    ("v5litepod-16" -> "v5e", "NVIDIA H100 80GB HBM3" -> "h100"). Only
    the SXM H100 maps to "h100"; "NVIDIA H100 PCIe", "NVIDIA H100 NVL"
    and every other unknown or empty name -> "cpu"."""
    name = (accelerator_type or "").lower()
    if name in GENERATIONS:
        return name
    for prefix, gen in _GENERATION_PREFIXES:
        if name.startswith(prefix):
            return gen
    if any(sxm in name for sxm in _H100_SXM_NAMES):
        return "h100"
    return "cpu"


def spec_of(accelerator_type: str) -> GenerationSpec:
    """The roofline row of an accelerator type or generation name."""
    return GENERATIONS[generation_of(accelerator_type)]


def peak_tflops_per_chip(accelerator_type: str) -> float:
    """Per-chip (per-card) bf16 peak of an accelerator type or generation
    name."""
    return spec_of(accelerator_type).peak_tflops_bf16


def cost_per_chip_hr(accelerator_type: str) -> float:
    """On-demand list $/chip-hr (a card's, for the ``h100`` row) of an
    accelerator type or generation name."""
    return spec_of(accelerator_type).cost_per_chip_hr
