"""Element factory registry (GstRegistry analog).

Plugins register element classes under factory names; ``make`` instantiates.
Reference analog: ``plugin_init`` registration (gstfluttml.c:31-62,
hype/src/lib.rs:46-52).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Type

from .element import Element

_registry: Dict[str, Type[Element]] = {}


def register(cls: Type[Element]) -> Type[Element]:
    """Class decorator: register an element factory by its FACTORY name."""
    if not cls.FACTORY:
        raise ValueError(f"{cls.__name__} has empty FACTORY")
    _registry[cls.FACTORY] = cls
    return cls


def make(factory: str, name: Optional[str] = None, **props) -> Element:
    _ensure_plugins_loaded()
    if factory not in _registry:
        raise KeyError(f"no such element factory {factory!r}; known: {sorted(_registry)}")
    return _registry[factory](name=name, **props)


def exists(factory: str) -> bool:
    _ensure_plugins_loaded()
    return factory in _registry


def factories() -> Dict[str, Type[Element]]:
    _ensure_plugins_loaded()
    return dict(_registry)


_plugins_loaded = False


def _ensure_plugins_loaded() -> None:
    """Lazy-import the built-in plugin modules so their @register decorators
    run (the analog of GStreamer scanning plugin .so files)."""
    global _plugins_loaded
    if _plugins_loaded:
        return
    _plugins_loaded = True
    import importlib
    for mod in (
        "flutpu_torch.core.elements",
        "flutpu_torch.core.queue",
        "flutpu_torch.codec",
    ):
        try:
            importlib.import_module(mod)
        except ImportError:
            pass
