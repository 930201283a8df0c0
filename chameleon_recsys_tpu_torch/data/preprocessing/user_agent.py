"""User-agent device/OS extraction for the Adressa ETL.

The reference shells out to the ``ua-parser`` package and then whitelists the
result against a fixed OS-family list (nar_module/nar/utils.py:145-180:
``get_os_list`` / ``extract_os_from_user_agent``).  ua-parser is not part of
this environment, so the detection is a small ordered regex table producing
the same ua-parser family names; anything off the whitelist collapses to the
default, exactly like the reference.

Also provides ``extract_domain_from_url`` (reference utils.py:183-190 — same
regex) used for referrer classification.

The port's copy of
``chameleon_recsys_tpu/data/preprocessing/user_agent.py``.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

# The reference's closed OS-family vocabulary (utils.py:149-171); anything
# else becomes `default_os` so the categorical cardinality stays fixed.
OS_LIST = [
    "iOS",
    "Android",
    "Windows Phone",
    "Windows Mobile",
    "Windows",
    "Mac OS X",
    "Mac OS",
    "Samsung",
    "FireHbbTV",
    "ATV OS X",
    "tvOS",
    "Chrome OS",
    "Debian",
    "Symbian OS",
    "BlackBerry OS",
    "Firefox OS",
    "Brew MP",
    "Chromecast",
    "webOS",
    "Gentoo",
    "Solaris",
]


def get_os_list() -> List[str]:
    return list(OS_LIST)


# Ordered detection table: first match wins.  Mobile/embedded families are
# checked before the desktop ones they embed strings of (e.g. 'Windows Phone'
# before 'Windows'; 'Android' before generic Linux distros).
_OS_PATTERNS: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat, re.IGNORECASE), family)
    for pat, family in [
        (r"iPhone|iPad|iPod|iOS", "iOS"),
        (r"Windows Phone", "Windows Phone"),
        (r"Windows (CE|Mobile)|IEMobile", "Windows Mobile"),
        (r"Android", "Android"),
        (r"CrKey", "Chromecast"),
        (r"CrOS", "Chrome OS"),
        (r"Apple TV|ATV OS X", "ATV OS X"),
        (r"tvOS", "tvOS"),
        (r"FireHbbTV", "FireHbbTV"),
        (r"Symbian|SymbOS|Series ?60|S60", "Symbian OS"),
        (r"BlackBerry|BB10|RIM Tablet", "BlackBerry OS"),
        (r"webOS|hpwOS", "webOS"),
        (r"Brew MP|BMP", "Brew MP"),
        (r"SMART-TV|SmartHub|Maple", "Samsung"),
        (r"Windows", "Windows"),
        (r"Mac OS X|Macintosh", "Mac OS X"),
        (r"Debian", "Debian"),
        (r"Gentoo", "Gentoo"),
        (r"SunOS|Solaris", "Solaris"),
        # ua-parser flags Firefox OS via a mobile/tablet token with Gecko
        # Firefox and no other platform — all platform tokens are consumed
        # by the rows above by the time this row is reached.
        (r"\((Mobile|Tablet);.*Firefox", "Firefox OS"),
    ]
)


def extract_os_from_user_agent(
    user_agent: Optional[str], default_os: str = "Other"
) -> str:
    """OS family of a raw User-Agent header, whitelisted against OS_LIST
    (reference utils.py:173-180 semantics: Symbian*/BlackBerry* variants fold
    into their family; unknown families → ``default_os``)."""
    if not user_agent:
        return default_os
    for pattern, family in _OS_PATTERNS:
        if pattern.search(user_agent):
            return family if family in OS_LIST else default_os
    return default_os


_DEVICE_PATTERNS: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(pat, re.IGNORECASE), group)
    for pat, group in [
        (r"iPad|Tablet|Kindle|Silk|PlayBook|RIM Tablet", "Tablet"),
        (
            r"Mobi|iPhone|iPod|Android.*Mobile|Windows Phone|BlackBerry|"
            r"BB10|Opera Mini|Symbian|webOS",
            "Mobile",
        ),
        (r"SMART-TV|SmartHub|Apple TV|tvOS|CrKey|HbbTV|NetCast|Roku", "TV"),
        (r"bot|crawler|spider|slurp|facebookexternalhit", "Bot"),
    ]
)


def extract_device_group_from_user_agent(
    user_agent: Optional[str], default_group: str = "Desktop"
) -> str:
    """Coarse device group (Tablet | Mobile | TV | Bot | Desktop) — the
    deviceGroup axis of the session schema."""
    if not user_agent:
        return default_group
    for pattern, group in _DEVICE_PATTERNS:
        if pattern.search(user_agent):
            return group
    return default_group


_DOMAIN_PATTERN = re.compile(
    r"^(?:https?:\/\/)?(?:[^@\/\n]+@)?(?:www\.)?([^:\/\n]+)"
)


def extract_domain_from_url(url: Optional[str]) -> Optional[str]:
    """Leading domain of a URL (reference utils.py:183-190 — group(0) like
    the reference, i.e. includes any scheme prefix that matched)."""
    if url is None:
        return None
    s = _DOMAIN_PATTERN.search(url)
    return None if s is None else s.group(0)


def enrich_click_context_with_user_agent(context: dict) -> dict:
    """Fill ``os`` / ``device`` into a click-context dict from its
    ``user_agent`` field when the ETL input lacks the parsed columns (the
    repo's sessionizer otherwise assumes they already exist)."""
    ua = context.get("user_agent")
    if ua is None:
        return context
    out = dict(context)
    out.setdefault("os", extract_os_from_user_agent(ua))
    out.setdefault("device", extract_device_group_from_user_agent(ua))
    return out
