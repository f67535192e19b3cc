"""Configuration `courtyard`: the Courtyard, a Sponza-class stand-in scene.

Frozen copy of the port's generator (`pt_torch/scene/standin.py`,
`create_courtyard_scene`, itself a copy of `pt/scene/standin.py`), numpy
only, building the scene through the builder and classes it is handed, as
an importer would. At detail 1.0 it has 339,828 indices in its models, 403
instances, 1135 flattened segments (more than the shared-BLAS cap, so the
port's "auto" policy keeps it flat: SBVH collapsed to BF8, kernels K1/K2,
the opaque/alpha split with its alpha re-trace rounds), 59 textures at
4k/2k/1k/512 before the pool's memory budget, 4 point lights and a
directional light, and its own camera.

A stand-in: the repository holds no public scene at this scale (Intel
Sponza's files are not in it), and no public source bears out these counts;
they are the generator's own.

Deterministic: every random draw comes from fixed seeds in a fixed order.
Run seeds change only the RNG's first frame index, never the scene.
"""

from __future__ import annotations

import math

import numpy as np

NAME = "courtyard"
SOURCE = ("Procedural stand-in for Intel Sponza (not in the repo), "
          "github.com/piotrprzybyszdev/Path-Tracing ExampleScenes.cpp:82-236; "
          "its sizes are pt/scene/standin.py's own")
# keys changed from the source: none
REDUCED: list = []
# sizes set here, not by the source
ASSUMED = {"film": "3840x2160, the source's 4K converged frame",
           "samples_per_step": 1,
           "instancing": "auto (flat at detail 1.0)"}
# the generator's parameters, as run
PARAMS = {"detail": 1.0, "tex_scale": 1.0}
# PathTracingSettings: the port's defaults, 5 bounces
SETTINGS = {"bounce_count": 5}


def _field(n: int, phase) -> np.ndarray:
    """Band-limited procedural field in [0, 1] at any size: the two
    low-frequency octaves, plus a higher octave (derived
    from the same phases, no extra rng draws) so large textures carry
    texel-scale detail for the mip chain to resolve."""
    yy, xx = np.meshgrid(np.linspace(0, 8, n, dtype=np.float32),
                         np.linspace(0, 8, n, dtype=np.float32),
                         indexing="ij")
    f = (np.sin(xx * 1.0 + phase[0]) * np.cos(yy * 1.3 + phase[1])
         + 0.5 * np.sin(xx * 3.1 + phase[2]) * np.sin(yy * 2.7 + phase[3])
         + 0.25 * np.sin(xx * 17.3 + phase[2] * 1.7)
         * np.cos(yy * 15.1 + phase[3] * 1.3))
    f = (f - f.min()) / max(float(np.ptp(f)), 1e-9)
    return f


def _noise_texture(rng, n, base, contrast=0.6, alpha=None):
    phase = rng.uniform(0, 2 * math.pi, 4)
    f = _field(n, phase)
    rgb = np.asarray(base)[None, None] * (1 - contrast + contrast * f[..., None])
    a = np.ones((n, n, 1)) if alpha is None else alpha[..., None]
    return np.concatenate([rgb, a], -1).astype(np.float32)


def _pbr_set(builder, ns, rng, name, base, rough_lo=0.4, rough_hi=0.95,
             metal=0.0, alpha=None, sizes=(1024, 512, 512)):
    """color/normal/roughness texture triple + material. `sizes` are the
    per-map resolutions (color, normal, roughness) — authored at
    Sponza-class sizes so mip-select + bilinear gather cost at benchmark
    scale is real (≙ the 1k-4k content TextureUploader budgets for,
    TextureUploader.cpp:551-595); the texture budget machinery downsizes
    exactly like the reference when the pool would exceed the VRAM
    budget."""
    phase = rng.uniform(0, 2 * math.pi, 4)
    n_c, n_n, n_r = sizes

    def colorize(f):
        rgb = np.asarray(base)[None, None] * (1 - 0.6 + 0.6 * f[..., None])
        a = (np.ones((*f.shape, 1)) if alpha is None
             else alpha[..., None])
        return np.concatenate([rgb, a], -1).astype(np.float32)

    color = colorize(_field(n_c, phase))
    f_n = _field(n_n, phase)
    slope = np.gradient(f_n, axis=0), np.gradient(f_n, axis=1)
    nrm = np.stack([-slope[1] * np.asarray(base)[0],
                    -slope[0] * np.asarray(base)[0],
                    np.ones((n_n, n_n)) * 0.25 / n_n * 96], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = np.concatenate([nrm * 0.5 + 0.5, np.ones((n_n, n_n, 1))],
                            -1).astype(np.float32)
    f_r = _field(n_r, phase)[..., None]
    rough = np.repeat(
        (rough_lo + (rough_hi - rough_lo) * np.asarray(base)[0] * f_r), 4,
        -1).astype(np.float32)

    def add(px, t, srgb):
        return builder.add_texture(ns.TextureInfo(
            name=f"{name}-{t.name.lower()}", type=t, pixels=px, is_srgb=srgb))

    return builder.add_material(name, ns.MetallicRoughnessMaterial(
        color=(1, 1, 1, 1), roughness=1.0, metalness=metal, ior=1.5,
        color_idx=add(color, ns.TextureType.COLOR, True),
        normal_idx=add(normal, ns.TextureType.NORMAL, False),
        roughness_idx=add(rough, ns.TextureType.ROUGHNESS, False)))


def _add_mesh(builder, ns, pos, nrm, uv, tris, opaque=True) -> int:
    vbase = builder.add_vertices(pos, uv, nrm)
    ibase = builder.add_indices(np.asarray(tris, np.uint32).ravel())
    return builder.add_geometry(ns.Geometry(vbase, len(pos), ibase,
                                         len(np.ravel(tris)), opaque))


def _grid_mesh(nx, nz, fx, scale_u=1.0):
    """Tessellated grid: fx(u, v) -> (x, y, z). Returns pos, nrm, uv, tris."""
    us = np.linspace(0, 1, nx)
    vs = np.linspace(0, 1, nz)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    pos = fx(uu, vv)
    du = np.gradient(pos, axis=0)
    dv = np.gradient(pos, axis=1)
    # normals + winding flipped together relative to cross(du, dv): the
    # +y-up re-authoring mirrors positions, so both must negate to keep
    # geometric and vertex normals consistent-outward
    nrm = -np.cross(du.reshape(-1, 3), dv.reshape(-1, 3))
    n = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(n, 1e-12)
    uv = np.stack([uu * scale_u, vv], -1).reshape(-1, 2)
    idx = np.arange(nx * nz).reshape(nx, nz)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate([np.stack([a, c, b], -1), np.stack([c, a, d], -1)])
    return pos.reshape(-1, 3), nrm, uv, tris


def _cylinder(radius, height, segs=32, rings=10):
    """Column shaft with slight entasis + cap discs."""
    th = np.linspace(0, 2 * math.pi, segs, endpoint=False)
    ys = np.linspace(0, height, rings)
    bulge = 1.0 + 0.06 * np.sin(np.linspace(0, math.pi, rings))
    pos, nrm, uv = [], [], []
    for ri, y in enumerate(ys):
        r = radius * bulge[ri]
        for si, t in enumerate(th):
            pos.append((r * math.cos(t), y, r * math.sin(t)))
            nrm.append((math.cos(t), 0.0, math.sin(t)))
            uv.append((si / segs * 4, ri / (rings - 1)))
    tris = []
    for ri in range(rings - 1):
        for si in range(segs):
            a = ri * segs + si
            b = ri * segs + (si + 1) % segs
            c = a + segs
            d = b + segs
            tris += [(a, c, b), (b, c, d)]
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32), np.asarray(tris, np.int64))


def _icosphere(subdiv=3):
    t = (1 + 5 ** 0.5) / 2
    verts = np.asarray([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                       np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(map(tuple, verts))
    for _ in range(subdiv):
        cache = {}
        nf = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = np.asarray(verts[a]) + np.asarray(verts[b])
                m /= np.linalg.norm(m)
                verts.append(tuple(m))
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nf
    pos = np.asarray(verts, np.float32)
    uv = np.stack([np.arctan2(pos[:, 2], pos[:, 0]) / (2 * math.pi) + 0.5,
                   pos[:, 1] * 0.5 + 0.5], -1).astype(np.float32)
    return pos, pos.copy(), uv, np.asarray(faces, np.int64)


def _tr(x, y, z, s=1.0, ry=0.0):
    c, si = math.cos(ry), math.sin(ry)
    m = np.asarray([[c * s, 0, si * s, x], [0, s, 0, y],
                    [-si * s, 0, c * s, z], [0, 0, 0, 1]], np.float64)
    return m


def generate(builder, ns, detail: float = 1.0,
             tex_scale: float = 1.0) -> None:
    rng = np.random.default_rng(42)
    d = detail

    def sz(*sizes):
        # Sponza-class authored sizes scaled by tex_scale (tests pass a
        # small scale; 1.0 gives the real 4k/2k/1k mix)
        return tuple(max(64, int(s * tex_scale)) for s in sizes)

    # --- materials (21 textured + 1 emissive = 22); texture sizes follow
    # Intel-Sponza-class content: hero surfaces 4k color + 2k normal,
    # secondary 2k/1k, props 1k/512 ------------
    floor_m = _pbr_set(builder, ns, rng, "floor-stone", (0.55, 0.52, 0.48),
                       sizes=sz(4096, 2048, 1024))
    wall_sizes = [sz(4096, 2048, 1024)] + [sz(2048, 1024, 1024)] * 3
    wall_ms = [_pbr_set(builder, ns, rng, f"wall-{i}", c, sizes=wall_sizes[i])
               for i, c in enumerate(
        [(0.75, 0.68, 0.58), (0.7, 0.6, 0.5), (0.62, 0.58, 0.52),
         (0.58, 0.5, 0.44)])]
    curtain_ms = [_pbr_set(builder, ns, rng, f"curtain-{i}", c, 0.6, 0.95,
                           sizes=sz(1024, 512, 512))
                  for i, c in enumerate([(0.65, 0.12, 0.12),
                                         (0.12, 0.35, 0.12),
                                         (0.15, 0.2, 0.55)])]
    column_ms = [_pbr_set(builder, ns, rng, f"column-{i}", c,
                          sizes=sz(2048, 1024, 512))
                 for i, c in enumerate([(0.8, 0.78, 0.72), (0.7, 0.68, 0.62),
                                        (0.6, 0.58, 0.55)])]
    rock_ms = [_pbr_set(builder, ns, rng, f"rock-{i}", c,
                        sizes=sz(1024, 512, 512))
               for i, c in enumerate([(0.4, 0.38, 0.36), (0.35, 0.3, 0.28)])]
    metal_ms = [_pbr_set(builder, ns, rng, f"metal-{i}", c, 0.15, 0.5, metal=1.0,
                         sizes=sz(1024, 1024, 512))
                for i, c in enumerate([(0.9, 0.7, 0.3), (0.6, 0.6, 0.65),
                                       (0.5, 0.35, 0.2)])]
    trim_ms = [_pbr_set(builder, ns, rng, f"trim-{i}", c, sizes=sz(512, 512, 512))
               for i, c in enumerate([(0.45, 0.42, 0.4), (0.3, 0.28, 0.26)])]
    pot_m = _pbr_set(builder, ns, rng, "pot-terracotta", (0.65, 0.35, 0.22),
                     sizes=sz(1024, 512, 512))
    water_m = builder.add_material("water", ns.MetallicRoughnessMaterial(
        color=(0.8, 0.9, 0.95, 1.0), roughness=0.02, metalness=0.0,
        ior=1.33, transmission=0.9, attenuation_color=(0.6, 0.8, 0.9),
        attenuation_distance=2.0))
    brazier_m = builder.add_material("brazier-glow", ns.MetallicRoughnessMaterial(
        color=(1.0, 0.5, 0.2, 1.0), emissive_color=(1.0, 0.45, 0.15),
        emissive_intensity=30.0, roughness=1.0))

    # foliage: alpha-tested leaf cards (MASK semantics, any-hit path)
    n = max(64, int(1024 * tex_scale))
    yy, xx = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    leaf_mask = np.zeros((n, n))
    for _ in range(10):                       # leaf blobs
        cx, cy = rng.uniform(-0.7, 0.7, 2)
        r = rng.uniform(0.15, 0.3)
        leaf_mask = np.maximum(
            leaf_mask, ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r)
    leaf_alpha = leaf_mask.astype(np.float64)
    leaf_ms = []
    for i, c in enumerate([(0.15, 0.4, 0.12), (0.25, 0.5, 0.18)]):
        color = _noise_texture(rng, n, c, alpha=leaf_alpha)
        ci = builder.add_texture(ns.TextureInfo(
            name=f"leaf-{i}", type=ns.TextureType.COLOR, pixels=color,
            is_srgb=True))
        leaf_ms.append(builder.add_material(
            f"leaf-{i}", ns.MetallicRoughnessMaterial(
                color=(1, 1, 1, 1), roughness=0.9, color_idx=ci)))

    root = builder.add_scene_node(0, np.eye(4))

    # --- floor: displaced stone court 30x18 --------------------------------
    def floor_f(u, v):
        x = (u - 0.5) * 30
        z = (v - 0.5) * 18
        y = 0.04 * np.sin(x * 2.1) * np.cos(z * 1.7) \
            + 0.02 * np.sin(x * 7.3) * np.sin(z * 6.1)
        return np.stack([x, y, z], -1)

    nf = max(2, int(150 * d))
    geo = _add_mesh(builder, ns, *_grid_mesh(nf, nf, floor_f, scale_u=8.0))
    builder.add_model_instance(
        builder.add_model([ns.MeshInfo(geo, floor_m)]),
        builder.add_scene_node(root, np.eye(4)))

    # --- walls: two long arcade walls + two end walls, paneled -------------
    def wall(x0, z0, x1, z1, h, mat, nu, nv):
        dx, dz = x1 - x0, z1 - z0

        def f(u, v):
            bump = 0.05 * np.sin(u * 23) * np.sin(v * 17)
            return np.stack([x0 + u * dx + bump * dz / math.hypot(dx, dz),
                             v * h,
                             z0 + u * dz - bump * dx / math.hypot(dx, dz)],
                            -1)
        g = _add_mesh(builder, ns, *_grid_mesh(nu, nv, f, scale_u=6.0))
        builder.add_model_instance(
            builder.add_model([ns.MeshInfo(g, mat)]),
            builder.add_scene_node(root, np.eye(4)))

    nu, nv = max(2, int(90 * d)), max(2, int(30 * d))
    wall(-15, -9, 15, -9, 9.0, wall_ms[0], nu, nv)
    wall(15, 9, -15, 9, 9.0, wall_ms[1], nu, nv)
    wall(15, -9, 15, 9, 9.0, wall_ms[2], max(2, int(54 * d)), nv)
    wall(-15, 9, -15, -9, 9.0, wall_ms[3], max(2, int(54 * d)), nv)

    # --- colonnade: ONE column model, 28 instances -------------------------
    cp, cn, cuv, ct = _cylinder(0.35, 6.0, segs=max(8, int(48 * d)),
                                rings=max(3, int(16 * d)))
    shaft = _add_mesh(builder, ns, cp, cn, cuv, ct)
    bp, bn, buv, bt = _icosphere(2)
    cap = _add_mesh(builder, ns, bp * np.asarray([[0.5, 0.22, 0.5]],
                                             np.float32), bn, buv, bt)
    col_model = builder.add_model([
        ns.MeshInfo(shaft, column_ms[0]),
        ns.MeshInfo(cap, column_ms[1], _tr(0, 6.1, 0)),
        ns.MeshInfo(cap, column_ms[2], _tr(0, -0.1, 0))])
    for i in range(18):
        x = -13.6 + i * 1.6
        for z in (-6.5, 6.5):
            builder.add_model_instance(
                col_model,
                builder.add_scene_node(root, _tr(x, 0.0, z,
                                                 ry=rng.uniform(0, 6.3))))

    # --- curtains between columns: wavy cloth sheets ------------------------
    nc = max(2, int(64 * d))
    for i in range(6):
        x0 = -12 + i * 4.2
        side = -6.4 if i % 2 == 0 else 6.4
        ph = rng.uniform(0, 6.3)

        def cf(u, v, x0=x0, side=side, ph=ph):
            return np.stack([
                x0 + u * 3.4,
                0.4 + v * 5.0,
                side + 0.35 * np.sin(u * 9 + ph) * (0.3 + 0.7 * v)], -1)
        gcur = _add_mesh(builder, ns, *_grid_mesh(nc, nc, cf, scale_u=2.0))
        builder.add_model_instance(
            builder.add_model([ns.MeshInfo(gcur, curtain_ms[i % 3])]),
            builder.add_scene_node(root, np.eye(4)))

    # --- foliage: instanced crossed alpha cards (vines + bushes) -----------
    quad_pos = np.asarray([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)],
                          np.float32)
    quad_nrm = np.tile(np.asarray([(0, 0, 1)], np.float32), (4, 1))
    quad_uv = np.asarray([(0, 1), (1, 1), (1, 0), (0, 0)], np.float32)
    quad_tris = np.asarray([(0, 1, 2), (2, 3, 0)], np.int64)
    cards = [_add_mesh(builder, ns, quad_pos, quad_nrm, quad_uv, quad_tris,
                       opaque=False) for _ in range(2)]
    bush = builder.add_model([
        ns.MeshInfo(cards[0], leaf_ms[0]),
        ns.MeshInfo(cards[0], leaf_ms[0], _tr(0, 0, 0, ry=math.pi / 2)),
        ns.MeshInfo(cards[1], leaf_ms[1], _tr(0, 0, 0, ry=math.pi / 4))])
    n_bush = int(330 * d)
    for _ in range(n_bush):
        x = rng.uniform(-14, 14)
        z = rng.uniform(-8.5, 8.5)
        if abs(z) < 5.0 and abs(x) < 11:      # keep the court walkable
            z = math.copysign(rng.uniform(5.0, 8.5), z - 1e-3)
        s = rng.uniform(0.3, 0.9)
        builder.add_model_instance(
            bush, builder.add_scene_node(
                root, _tr(x, s, z, s=s, ry=rng.uniform(0, 6.3))))

    # --- rocks + pots + braziers -------------------------------------------
    rp, rn_, ruv, rt = _icosphere(max(1, int(3 * min(d, 1.0))))
    rock = _add_mesh(builder, ns, rp * np.asarray([[1.0, 0.7, 0.9]], np.float32),
                     rn_, ruv, rt)
    rock_model = builder.add_model([ns.MeshInfo(rock, rock_ms[0])])
    pot_model = builder.add_model([ns.MeshInfo(rock, pot_m)])
    for i in range(16):
        s = rng.uniform(0.2, 0.6)
        builder.add_model_instance(
            rock_model if i % 3 else pot_model,
            builder.add_scene_node(root, _tr(rng.uniform(-14, 14), s * 0.4,
                                             rng.uniform(-8, 8), s=s)))

    # braziers: emissive spheres + point lights
    brazier = builder.add_model([ns.MeshInfo(rock, brazier_m)])
    for (bx, bz) in ((-10, 0), (10, 0), (0, -5), (0, 5)):
        builder.add_model_instance(
            brazier, builder.add_scene_node(root, _tr(bx, 1.2, bz, s=0.25)))
        builder.add_point_light(ns.PointLight(
            color=(14.0, 6.0, 2.2), position=(bx, 1.6, bz),
            attenuation_constant=0.0, attenuation_quadratic=1.0))

    # pool: transmissive water slab
    def pf(u, v):
        return np.stack([(u - 0.5) * 6, 0.12 - 0.02 * np.sin(u * 20)
                         * np.cos(v * 18), (v - 0.5) * 3.2], -1)
    pool = _add_mesh(builder, ns, *_grid_mesh(max(2, int(30 * d)),
                                          max(2, int(30 * d)), pf))
    builder.add_model_instance(
        builder.add_model([ns.MeshInfo(pool, water_m)]),
        builder.add_scene_node(root, np.eye(4)))

    # metal trims on the end walls
    tp, tn, tuv, tt = _cylinder(0.08, 17.5, segs=max(6, int(12 * d)),
                                rings=3)
    rail = _add_mesh(builder, ns, tp, tn, tuv, tt)
    for i, mat in enumerate(metal_ms + trim_ms):
        y = 2.0 + 1.2 * i
        m = np.asarray([[0, 0, 1, 14.6 - 29.2 * (i % 2)], [-1, 0, 0, y],
                        [0, -1, 0, -8.75], [0, 0, 0, 1]], np.float64)
        builder.add_model_instance(
            builder.add_model([ns.MeshInfo(rail, mat)]),
            builder.add_scene_node(root, m))

    # --- sky + sun ----------------------------------------------------------
    h, w = 24, 48
    v = np.linspace(0.0, 1.0, h)[:, None]
    sky = np.stack([0.7 + 0.5 * v, 0.9 + 0.4 * v, 1.4 + 0.2 * v],
                   -1).astype(np.float32)
    builder.set_skybox(ns.Skybox(kind=ns.SkyboxKind.EQUIRECT,
                              image=np.broadcast_to(sky, (h, w, 3)).copy()))
    builder.set_directional_light(ns.DirectionalLight(
        color=(5.0, 4.6, 4.0), direction=(0.35, -0.82, 0.45)))
    builder.add_camera(ns.InputCamera(55.0, 200.0, 0.1, (-12.0, 2.2, 0.0),
                                   (1.0, 0.08, 0.12)))
