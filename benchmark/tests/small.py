"""Small versions of the configurations, for tests on the CPU: the same
structures, sources and monitors at a coarser grid and a shorter run."""

from benchmark.harness import cell

# the coupler runs until its pulse has passed the ports, as at full size:
# the k-step tier (the card's choice for it) samples its DFTs on the
# Nyquist stride, which matches a DFT of every step only for fields that
# have decayed, not for a pulse cut off on its way
SHRINK = {
    "soi_dc": dict(dl_um=0.05, domain_um=[2.0, 1.6, 1.0], pml_layers=6,
                   run_time_s=1.5e-13, source_inset_um=0.4,
                   monitor_inset_um=0.4, mode_plane_um=[0.7, 0.8],
                   port_plane_um=[1.2, 0.8]),
    "au_grating": dict(cells_xy=16, cells_z=40, pml_layers=6, dl_um=0.04,
                       run_time_s=2e-14),
}


def small_draw(config, mix, seed, _draw=cell.draw):
    p = _draw(config, mix, seed)
    p.update(SHRINK[config["name"]])
    return p


def params(workload, seed=2200000007):
    c = cell.load(workload)
    return c, small_draw(c["config"], c["mix"], seed)
