"""Worker parameterization (paper Table 6) and fleet-level parameters.

Units used throughout the scheduling stack:
  time    seconds
  work    CPU-seconds (one CPU worker serves 1.0 work unit per second;
          an FPGA worker with speedup S serves S work units per second)
  power   watts
  energy  joules
  cost    dollars (rates in $/s internally; specs take $/hr)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class WorkerSpec:
    """A single worker type: CPU, FPGA, or any accelerator (paper §4.5).

    The scheduler is agnostic to what the worker physically is; it only
    consumes these parameters. ``speedup`` is relative to the baseline CPU
    worker (CPU speedup == 1.0 by definition).
    """

    name: str
    spin_up_s: float          # allocation latency (reconfiguration for FPGAs)
    spin_down_s: float        # deallocation latency
    speedup: float            # request processing rate relative to CPU
    busy_w: float             # power when serving a request
    idle_w: float             # power when spun up but idle
    cost_per_hr: float        # prorated occupancy cost while allocated

    # Workers draw busy power during spin up and spin down (paper §5.1).
    @property
    def spin_up_energy_j(self) -> float:
        return self.spin_up_s * self.busy_w

    @property
    def spin_down_energy_j(self) -> float:
        return self.spin_down_s * self.busy_w

    @property
    def cost_per_s(self) -> float:
        return self.cost_per_hr / 3600.0

    def replace(self, **kw) -> "WorkerSpec":
        return dataclasses.replace(self, **kw)


# Paper Table 6 defaults (non-italicized values).
DEFAULT_CPU = WorkerSpec(
    name="cpu",
    spin_up_s=0.005,
    spin_down_s=0.005,
    speedup=1.0,
    busy_w=150.0,
    idle_w=30.0,
    cost_per_hr=0.668,
)

DEFAULT_FPGA = WorkerSpec(
    name="fpga",
    spin_up_s=10.0,
    spin_down_s=0.1,
    speedup=2.0,
    busy_w=50.0,
    idle_w=20.0,
    cost_per_hr=0.982,
)

# Sensitivity-analysis variants (italicized values in Table 6).
FPGA_SPIN_UP_VARIANTS_S = (1.0, 10.0, 60.0, 100.0)
FPGA_SPEEDUP_VARIANTS = (1.0, 2.0, 4.0)
FPGA_BUSY_W_VARIANTS = (25.0, 50.0, 100.0)
FPGA_IDLE_W_VARIANTS = (10.0, 20.0, 30.0)
CPU_IDLE_W_VARIANTS = (10.0, 30.0, 50.0)


@dataclass(frozen=True)
class FleetParams:
    """Everything the schedulers need to know about the worker fleet.

    ``interval_s`` is the scheduling interval T_s; the paper lower-bounds it
    by the FPGA spin-up latency and uses T_s = A_f throughout (§4.2). The
    idle timeout equals the allocation interval for FPGAs (§5.1); CPU workers
    are assumed to have negligible idle overhead (§4.2) so their timeout is
    short and separately configurable.
    """

    cpu: WorkerSpec = DEFAULT_CPU
    fpga: WorkerSpec = DEFAULT_FPGA
    interval_s: float | None = None        # None -> fpga.spin_up_s
    cpu_idle_timeout_s: float = 1.0
    max_fpgas: int = 1024                  # N_f cap (abundant by default, §4.5)
    max_cpus: int = 100_000                # N_c cap

    @property
    def T_s(self) -> float:
        return self.fpga.spin_up_s if self.interval_s is None else self.interval_s

    @property
    def fpga_idle_timeout_s(self) -> float:
        return self.T_s

    @property
    def S(self) -> float:
        """FPGA speedup factor over CPU (paper symbol S)."""
        return self.fpga.speedup / self.cpu.speedup

    def replace(self, **kw) -> "FleetParams":
        return dataclasses.replace(self, **kw)

    # ---- idealized FPGA-only reference platform (paper §5.1 Metrics) ----
    # Zero spin-up and idling overheads: only compute energy/cost. All
    # reported energy-efficiency and relative-cost numbers are normalized
    # against these.

    def ideal_energy_j(self, total_work_cpu_s: float) -> float:
        return (total_work_cpu_s / self.S) * self.fpga.busy_w

    def ideal_cost_usd(self, total_work_cpu_s: float) -> float:
        return (total_work_cpu_s / self.S) * self.fpga.cost_per_s


DEFAULT_FLEET = FleetParams()
