"""Scene and render-settings files."""

from .scene_json import load_scene, load_settings

__all__ = ["load_scene", "load_settings"]
