"""The bytes bound of a cast, taken at ``intersect_scene``'s interface, so
that it counts the same work whatever implements the cast: each active
ray's origin, direction and ``t_max`` (when the cast has one) read once,
every ray's ``active`` flag read once, the four outputs (triangle id, t, u,
v) written once, and the scene's triangles at 36 bytes each (9 float32)
read once.  It counts no operations, which depend on a walk that only an
implementation does, so the time it gives is a lower bound."""

TRIANGLE_BYTES = 36
RAY_BYTES = 24                  # origin and direction, f32
T_MAX_BYTES = 4
ACTIVE_BYTES = 1
OUTPUT_BYTES = 16               # i32 id, f32 t, u, v


def cast_bytes(rays: int, active: int, has_t_max: bool,
               n_triangles: int) -> int:
    per_active = RAY_BYTES + (T_MAX_BYTES if has_t_max else 0)
    return (active * per_active + rays * (ACTIVE_BYTES + OUTPUT_BYTES)
            + n_triangles * TRIANGLE_BYTES)
