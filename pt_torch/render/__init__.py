"""Render core: RNG, rays, shading math, BSDF, lights, materials, textures
and the wavefront integrator."""

from pt_torch.render.integrator import (PathTracingSettings, render_flat,
                                        render_image)
from pt_torch.render.bsdf import MaterialSample
from pt_torch.render.textures import (DeviceTextures, TexturePoolBuilder,
                                      default_texture_pool)
