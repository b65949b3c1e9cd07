"""fireFoam: buoyancy-driven diffusion flames, with optional pyrolysing
fuel surfaces and a water film (port of openfoam-2.2.x_tpu/solvers/
firefoam.py: `FireConfig`, `fire_step`, `initial_state`, `make_step`;
reference applications/solvers/combustion/fireFoam/ YEqn.H, hsEqn.H with
infinitelyFastChemistry, and the surfaceFilm / pyrolysis coupling).

Operator split per time step:
  1. flow: the buoyantPimpleFoam step (solvers/buoyantrho.py), with the
     P1/fvDOM radiation of models/radiation.py when the config has one;
  2. species: all nS mass fractions as one [nC, nS] field, one multi-RHS
     solve (the SpMV's column instance at C = nS), with the pyrolysis
     fuel release added to the fuel column of the wall cells by
     `index_add_` (an atomic sum on the card);
  3. combustion: the closure of models/combustion.py (the reference's
     default infinitelyFastChemistry), the heat release into T;
  4. regions (optional, explicit, one step behind): the pyrolysis columns
     under the `burning` patch faces take the convective wall flux and
     release fuel gas; a water film evaporates against the same flux.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.fields import VolField
from . import linear
from .buoyantrho import BuoyantRhoConfig, buoyantrho_step
from .reacting import Y_CONTROLS, combust, laminar_mu, species_eqn


class FireConfig(NamedTuple):
    flow: BuoyantRhoConfig
    chem: Any                    # models/chemistry.ChemistryModel
    W: Any                       # [nS] molecular weights
    combustion: Any = None       # models/combustion.Combustion
    Sc: float = 0.7
    y_controls: Dict = None
    fuel_index: int = 0          # the species the pyrolysis gas feeds
    # region models (None = off)
    pyro_mesh: Any = None        # regionmodels.FilmMesh over the patches
    pyro_cfg: Any = None         # regionmodels.PyrolysisConfig
    film_mesh: Any = None        # FilmMesh over the film patches
    film_cfg: Any = None         # regionmodels.FilmConfig (thermo=True)
    h_conv: float = 20.0         # wall convective coefficient [W/m^2/K]
    T_ref_wall: float = 300.0    # solid/film reference temperature


def fire_step(mesh, state: Dict, dt: Any, cfg: FireConfig
              ) -> Tuple[Dict, Dict]:
    th = cfg.flow.thermo
    y_ctrl = cfg.y_controls or Y_CONTROLS
    rdt = 1.0 / dt

    state, diag = buoyantrho_step(mesh, state, dt, cfg.flow)
    T: VolField = state["T"]
    rho = state["rho0"]
    rho0 = state.get("rho_prev", rho)

    # -- species (multi-RHS, as reactingFoam) --------------------------------
    Y: VolField = state["Y"]
    mu = laminar_mu(mesh, th, T)
    YEqn = species_eqn(mesh, state, Y, rho, rho0, rdt, mu, cfg.Sc)
    if cfg.pyro_mesh is not None and "pyro" in state:
        # the pyrolysis fuel release into the wall-adjacent cells
        pm = cfg.pyro_mesh
        m_gas = state.get("pyro_m_gas",
                          rho.new_zeros(pm.n_faces))
        src = rho.new_zeros((mesh.n_cells, Y.data.shape[1]))
        src[:, cfg.fuel_index].index_add_(0, pm.owner_cells,
                                          m_gas * pm.area)   # kg/s
        YEqn = YEqn.add_source(src / mesh.v[:, None], mesh)
    Ydata, yperf = linear.solve(mesh, YEqn, Y.data, y_ctrl)
    Ydata = torch.clamp(Ydata, 0.0, 1.0)
    diag["Y"] = yperf

    # -- combustion (constant-pressure heat release) -------------------------
    Wv = torch.as_tensor(cfg.W, dtype=mesh.v.dtype, device=mesh.device)
    c = rho[:, None] * Ydata / Wv[None, :]
    c_new = combust(mesh, cfg, state, c, T, rho, mu, dt)
    dc = c_new - c
    q = -(dc @ cfg.chem.hf) * rdt                 # J/m^3/s
    cp = th.Cp_of(T.data)
    T = T.with_data(T.data + dt * q
                    / (torch.clamp(rho, min=cfg.flow.rho_min) * cp))
    T = T.correct_boundary_conditions(mesh)
    Ydata = c_new * Wv[None, :] / rho[:, None]
    Ydata = Ydata / torch.clamp(torch.sum(Ydata, dim=1, keepdim=True),
                                min=1e-12)
    Y = Y.with_data(Ydata)
    diag["Qdot_max"] = torch.max(q)

    new_state = dict(state)
    new_state.update(T=T, Y=Y, Y0=Ydata, rho_prev=rho, T0=T.data)

    # -- region models (explicit coupling) -----------------------------------
    if cfg.pyro_mesh is not None and "pyro" in state:
        from ..regionmodels import pyro_step

        pm = cfg.pyro_mesh
        T_wallcell = T.data[pm.owner_cells]
        q_in = cfg.h_conv * (T_wallcell - state["pyro"]["Ts"][:, 0])
        pyro_new, pdiag = pyro_step(state["pyro"], dt, cfg.pyro_cfg,
                                    torch.clamp(q_in, min=0.0))
        new_state["pyro"] = pyro_new
        new_state["pyro_m_gas"] = pdiag["m_gas"]
        diag["pyro_T_surf"] = pdiag["T_surf_max"]
        diag["pyro_m_gas"] = torch.sum(pdiag["m_gas"] * pm.area)
    if cfg.film_mesh is not None and "film" in state:
        from ..regionmodels import film_step

        fmm = cfg.film_mesh
        T_wallcell = T.data[fmm.owner_cells]
        q_wall = cfg.h_conv * (T_wallcell - state["film"]["Tf"])
        film_new, fdiag = film_step(fmm, state["film"], dt,
                                    cfg.film_cfg, q_wall=q_wall)
        new_state["film"] = film_new
        diag["film_mass"] = fdiag["mass"]
        diag["film_evap"] = fdiag["evap_rate"]
    return new_state, diag


def initial_state(mesh, U, p_rgh, T, Y: VolField, thermo,
                  g=(0.0, -9.81, 0.0), turb_state=None,
                  cfg: Optional[FireConfig] = None) -> Dict:
    from .buoyantrho import initial_state as b_init

    st = b_init(mesh, U, p_rgh, T, thermo, g=g, turb_state=turb_state)
    st["Y"] = Y
    st["Y0"] = Y.data
    if cfg is not None and cfg.pyro_mesh is not None:
        from ..regionmodels import pyro_init

        st["pyro"] = pyro_init(cfg.pyro_mesh.n_faces, cfg.pyro_cfg,
                               T0=cfg.T_ref_wall, dtype=mesh.v.dtype,
                               device=mesh.device)
        st["pyro_m_gas"] = mesh.v.new_zeros(cfg.pyro_mesh.n_faces)
    if cfg is not None and cfg.film_mesh is not None:
        from ..regionmodels import film_init

        st["film"] = film_init(cfg.film_mesh, cfg.film_cfg,
                               delta0=1e-4, T0=cfg.T_ref_wall)
    return st


def make_step(mesh, cfg: FireConfig):
    """(state, dt) -> (state, diag) for one time step."""
    def step(state, dt):
        return fire_step(mesh, state, dt, cfg)

    return step
