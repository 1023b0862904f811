"""The port's host RSS reading (core/extensions.py `host_rss_gb`, logged as
`host/rss_gb`) scales the resident page count of /proc/self/statm by the
host's page size, not by a fixed 4096: on 16 KiB and 64 KiB page hosts a
fixed 4096 reads 4x and 16x too low."""

import os

import pytest

from synthesis_in_style_tpu_torch.core import extensions


@pytest.mark.parametrize("page_size", [4096, 16384, 65536])
def test_host_rss_uses_the_page_size(tmp_path, monkeypatch, page_size):
    statm = tmp_path / "statm"
    statm.write_text("300000 262144 1000 10 0 5000 0\n")  # resident: 262144 pages
    monkeypatch.setattr(extensions.os, "sysconf",
                        lambda name: page_size if name == "SC_PAGE_SIZE" else os.sysconf(name))
    assert extensions.host_rss_gb(str(statm)) == round(262144 * page_size / 2**30, 3)


def test_host_rss_of_this_process_and_a_missing_file(tmp_path):
    rss = extensions.host_rss_gb()
    if os.path.exists("/proc/self/statm"):
        assert 0 < rss < 1024
    assert extensions.host_rss_gb(str(tmp_path / "missing")) is None
