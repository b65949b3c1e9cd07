"""regionModels: thin regions coupled to the primary mesh (port of
openfoam-2.2.x_tpu/regionmodels/__init__.py; reference
src/regionModels/{regionModel,singleLayerRegion,surfaceFilmModels,
pyrolysisModels}/).

  - filmmesh.py: the film-region mesh, a 2D FV mesh over the faces of a
    primary-mesh wall patch, built on the host once (a copy);
  - film.py: kinematicSingleLayer + thermoSingleLayer, explicit upwind
    edge fluxes summed into the film cells by `index_add_`;
  - pyrolysis.py: reactingOneDim, in-depth 1D solid columns under every
    wall face, advanced together as one [nF, nL] array.
"""

from .filmmesh import FilmMesh, build_film_mesh
from .film import FilmConfig, film_init, film_step
from .pyrolysis import PyrolysisConfig, pyro_init, pyro_step

__all__ = [
    "FilmMesh", "build_film_mesh",
    "FilmConfig", "film_init", "film_step",
    "PyrolysisConfig", "pyro_init", "pyro_step",
]
