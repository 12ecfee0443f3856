"""String-keyed class factory utilities (mirrors smol/utils/class_utils.py).

Counterpart of ``smol_tpu/utils/class_utils.py``, whose code it copies. In
this module "the reference" is smol (CederGroupHub/smol).
"""

from __future__ import annotations


def class_name_from_str(class_str: str) -> str:
    """Convert 'table-flip' / 'table_flip' / 'TableFlip' to 'TableFlip'."""
    if "-" in class_str or "_" in class_str:
        parts = class_str.replace("-", "_").split("_")
        return "".join(p.capitalize() for p in parts)
    return class_str[0].upper() + class_str[1:]


def get_subclasses(base_class) -> dict:
    """Recursively collect {name: class} for all subclasses of base_class."""
    subclasses = {}
    for subclass in base_class.__subclasses__():
        subclasses[subclass.__name__] = subclass
        subclasses.update(get_subclasses(subclass))
    return subclasses


def get_subclasses_str(base_class, split: bool = True) -> tuple:
    """Names of all subclasses, optionally split into lowercase words."""
    names = []
    for name in get_subclasses(base_class):
        if split:
            out, word = [], ""
            for ch in name:
                if ch.isupper() and word:
                    out.append(word)
                    word = ch.lower()
                else:
                    word += ch.lower()
            out.append(word)
            names.append("-".join(out))
        else:
            names.append(name.lower())
    return tuple(names)


def derived_class_factory(class_str: str, base_class, *args, **kwargs):
    """Instantiate a subclass of base_class by its name."""
    try:
        derived = get_subclasses(base_class)[class_str]
        return derived(*args, **kwargs)
    except KeyError as err:
        raise NotImplementedError(
            f"{class_str} is not implemented as a subclass of {base_class.__name__}."
        ) from err
