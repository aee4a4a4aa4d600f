"""CloudStorage credential plumbing:
resolution order is Config flag -> conventional env var -> None (so the
SDK's own default chain — instance metadata, ~/.aws, ADC — takes over),
and ``storage_for_uri`` hands the Config only to the built-in cloud
factory, never to registered third-party factories.

The PyTorch port's copy of ``tests/test_external_storage.py``: the same
cases run against ``ray_memory_management_tpu_torch``.
"""

import sys
import types

import pytest

from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core import external_storage as ext
from _port_fixtures import one_intra_op_thread  # noqa: F401

_ENV_VARS = ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
             "AWS_ENDPOINT_URL", "AWS_DEFAULT_REGION",
             "GOOGLE_APPLICATION_CREDENTIALS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in _ENV_VARS:
        monkeypatch.delenv(var, raising=False)


def test_credentials_default_to_none_for_sdk_chain():
    creds = ext.resolve_cloud_credentials(Config())
    assert creds == {"access_key": None, "secret_key": None,
                     "endpoint": None, "region": None,
                     "credentials_file": None}


def test_env_vars_fill_unset_flags(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "env-ak")
    monkeypatch.setenv("AWS_DEFAULT_REGION", "eu-west-1")
    monkeypatch.setenv("GOOGLE_APPLICATION_CREDENTIALS", "/tmp/sa.json")
    creds = ext.resolve_cloud_credentials(Config())
    assert creds["access_key"] == "env-ak"
    assert creds["region"] == "eu-west-1"
    assert creds["credentials_file"] == "/tmp/sa.json"
    assert creds["secret_key"] is None  # untouched fields stay None


def test_config_flag_beats_env_var(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "env-ak")
    monkeypatch.setenv("AWS_ENDPOINT_URL", "http://env:9000")
    cfg = Config(cloud_storage_access_key="cfg-ak",
                 cloud_storage_endpoint="http://cfg:9000")
    creds = ext.resolve_cloud_credentials(cfg)
    assert creds["access_key"] == "cfg-ak"
    assert creds["endpoint"] == "http://cfg:9000"


def test_empty_flag_falls_through_to_env(monkeypatch):
    """An empty-string flag (the default) must not mask the env var or
    the SDK chain — only a SET flag overrides."""
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "env-sk")
    creds = ext.resolve_cloud_credentials(
        Config(cloud_storage_access_key=""))
    assert creds["access_key"] is None
    assert creds["secret_key"] == "env-sk"


def test_no_config_resolves_from_env_only(monkeypatch):
    monkeypatch.setenv("AWS_DEFAULT_REGION", "us-central1")
    creds = ext.resolve_cloud_credentials(None)
    assert creds["region"] == "us-central1"
    assert creds["access_key"] is None


def test_s3_client_receives_only_resolved_fields(monkeypatch):
    """CloudStorage must pass resolved credentials as boto3 kwargs and
    OMIT unresolved ones (empty strings would mask the SDK chain)."""
    captured = {}

    def fake_client(service, **kw):
        captured["service"] = service
        captured["kw"] = kw
        return object()

    monkeypatch.setitem(
        sys.modules, "boto3",
        types.SimpleNamespace(client=fake_client))
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "env-ak")
    cfg = Config(cloud_storage_secret_key="cfg-sk",
                 cloud_storage_endpoint="http://minio:9000")
    store = ext.CloudStorage("s3://bucket/prefix", config=cfg)
    assert store.bucket == "bucket" and store.prefix == "prefix"
    assert captured["service"] == "s3"
    assert captured["kw"] == {
        "aws_access_key_id": "env-ak",        # env fallback
        "aws_secret_access_key": "cfg-sk",    # flag
        "endpoint_url": "http://minio:9000",  # flag
    }  # region unresolved -> omitted entirely


def test_storage_for_uri_passes_config_to_cloud_factory(monkeypatch):
    seen = {}

    def fake_client(service, **kw):
        seen["kw"] = kw
        return object()

    monkeypatch.setitem(
        sys.modules, "boto3",
        types.SimpleNamespace(client=fake_client))
    cfg = Config(cloud_storage_region="us-east-2")
    store = ext.storage_for_uri("s3://spill/objs", config=cfg)
    assert isinstance(store, ext.CloudStorage)
    assert seen["kw"] == {"region_name": "us-east-2"}


def test_storage_for_uri_keeps_plain_contract_for_third_party(monkeypatch):
    """Registered factories keep the documented factory(uri) signature —
    a third-party callable must never receive a config kwarg."""
    calls = []

    def factory(uri):  # no **kwargs on purpose: config would TypeError
        calls.append(uri)
        return ext.InMemoryStorage()

    monkeypatch.setitem(ext._SCHEMES, "custom", factory)
    store = ext.storage_for_uri("custom://anywhere", config=Config())
    assert isinstance(store, ext.InMemoryStorage)
    assert calls == ["custom://anywhere"]
