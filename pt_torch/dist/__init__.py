"""Multi-device rendering: film-row bands and sample groups over ranks, one
process per device (`torch.distributed`). Port of `pt.dist`."""

from pt_torch.dist.mesh import (assemble_film, film_mesh, film_mesh_multihost,
                                film_spp_mesh, rank_device,
                                render_image_sharded,
                                render_image_spp_sharded, render_spp_sharded)
