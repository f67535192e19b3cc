"""The Courtyard film gate: `make_courtyard_scene(0.1, 0.05)` (26,906
triangles, alpha-tested foliage and cards, 59 textures) through the port's
render loop against `pt`'s Renderer on its brute backend, at 48², 2 spp
(one spp-major group of two), 3 bounces: film MSE < 1e-3, the project's
film contract, and the ray counts within 1%. The port takes the static
split path (a BF8 tree with opaque and alpha subset trees, the alpha
re-trace loops).
"""

import numpy as np

from pt.render.integrator import PathTracingSettings as JSettings
from pt.run.renderer import Renderer as JRenderer
from pt.scene.standin import make_courtyard_scene as j_courtyard
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run.renderer import Renderer
from pt_torch.scene.standin import make_courtyard_scene

FILM_MSE = 1e-3


def test_courtyard_film_matches_pt_renderer():
    r = Renderer(PathTracingSettings(sample_count=2, bounce_count=3),
                 device="cpu")
    r.set_scene(make_courtyard_scene(0.1, 0.05), stream_textures=False)
    r.on_resize(48, 48)
    r.render()
    assert type(r.accel.bvh).__name__ == "BF8BVH"
    assert r.accel.alpha_split is not None
    jr = JRenderer(JSettings(sample_count=2, bounce_count=3,
                             backend="brute"))
    jr.set_scene(j_courtyard(0.1, 0.05), stream_textures=False)
    jr.on_resize(48, 48)
    jr.render()
    film, jfilm = r.film_mean(), jr.film_mean()
    assert film.shape == jfilm.shape == (48, 48, 3)
    assert np.isfinite(film).all() and film.max() > 0
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < FILM_MSE, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced
