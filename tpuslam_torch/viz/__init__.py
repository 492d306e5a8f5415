from .framedrawer import draw_frame_overlay  # noqa: F401
from .mapdrawer import draw_map, save_map_png  # noqa: F401
