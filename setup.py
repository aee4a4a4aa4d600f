from setuptools import setup, find_packages

setup(
    name="ray_memory_management_tpu",
    version="0.1.0",
    packages=find_packages(include=["ray_memory_management_tpu*"]),
    package_data={"ray_memory_management_tpu.native": ["*.cpp", "Makefile"],
                  "ray_memory_management_tpu_torch": ["csrc/*.cu"]},
    # 3.12+ required: zero-copy store-buffer lifetime tracking uses PEP-688
    # (__buffer__ protocol) in serialization._StoreBufferView
    python_requires=">=3.12",
    entry_points={
        "console_scripts": [
            "rmt=ray_memory_management_tpu.scripts.cli:main",
        ],
    },
)
